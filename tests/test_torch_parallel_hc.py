"""HaploCart of the port as two joined processes on the CPU, against the
JAX package.

Two ranks of `vgan_tpu_torch.cli haplocart --nproc 2` (through
tests/_torch_rank.py, which keeps host 0's final_vec and each rank's
launch counts and read count) map their own halves of the reads, remove
the duplicates of their own half only (the JAX package's multi-process
semantics: a read count and final_vec that may differ from one
process's), and all-reduce the per-node accumulator. Host 0's final_vec
must equal the sum over the two halves of JAX's single-process scorer
on each half's mapped, sorted and deduplicated alignments (rtol 1e-10:
two f64 sums added in another order), and host 0's TSV must carry JAX's
prediction for that sum and host 0's own read count. Only host 0
writes."""
import json
import os

import numpy as np

import _torch_world as world
from test_torch_parallel_procs import run_ranks
from vgan_tpu.io import fastx as jax_fastx
from vgan_tpu.mapper.giraffe import BatchedMapper as JaxMapper
from vgan_tpu.pipelines import haplocart as jax_hc
from vgan_tpu.pipelines import haplocart_device as jax_hd
from vgan_tpu.pipelines import haplocart_runner as jax_runner
from vgan_tpu_torch.graph import synth
from vgan_tpu_torch.parallel.multihost import shard_bounds

HERE = os.path.dirname(os.path.abspath(__file__))


def jax_shard_vec(db, mapper, reads):
    alns = [a for a in mapper.map_reads(reads) if a.identity != 0]
    alns = jax_hc.remove_duplicates(jax_runner.gamsort(alns))
    return jax_hd.score_alignments_device(db, alns, mesh=None), len(alns)


def test_haplocart_two_ranks_match_jax_shard_sum(tmp_path):
    _g, db_dir, fq, _r = world.build(synth, tmp_path, n_bp=1500, n_haps=8,
                                     n_variants=24, n_reads=200)
    vec_path = str(tmp_path / "vec.npy")
    logs = run_ranks(
        [vec_path, "haplocart", "--db", db_dir, "-fq1", fq, "-o", "multi.tsv",
         "--device", "cpu", "--devices", "2", "--profile"],
        tmp_path, script=os.path.join(HERE, "_torch_rank.py"))
    ranks = sorted((json.loads(line[5:]) for log in logs
                    for line in log.splitlines() if line.startswith("RANK ")),
                   key=lambda r: r["rank"])
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        # each rank mapped and scored its own half (on the CPU the SW and
        # scorer wrappers run their plain versions: no kernel launch)
        assert r["launches"] == {"sw_scores": 0, "gather_score_hash": 0,
                                 "hc_node_scores": 0}
        assert r["stages_s"]["map"] > 0 and "score" in r["stages_s"]

    jdb = jax_runner.load_db(db_dir)
    mapper = JaxMapper(jdb.graph, k=31, w=11)
    reads = jax_fastx.read_fastq(fq)
    want, counts = np.zeros(len(jdb.path_names)), []
    for pid in range(2):
        lo, hi = shard_bounds(len(reads), pid, 2)
        vec, n = jax_shard_vec(jdb, mapper, reads[lo:hi])
        want += vec
        counts.append(n)
    assert [r["n_reads"] for r in ranks] == counts
    got = np.load(vec_path)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-10)

    lines = (tmp_path / "multi.tsv").read_text().splitlines()
    assert lines[0] == "#sample\tpredicted haplogroup\treads"
    assert lines[1].split("\t")[1:] == [jax_hc.predict(jdb, want),
                                        str(counts[0])]
    assert lines[1].split("\t")[1] == "hap5"
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["db", "reads.fq", "vec.npy", "multi.tsv"])
