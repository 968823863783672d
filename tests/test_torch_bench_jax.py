"""The port's bench phases against the JAX package on the same worlds and
reads, on the CPU at bench.py's smoke sizes: hc_toy_e2e's production
run_sample (prediction equal, final_vec to rtol 1e-12) and euka_realdb's
streamed scorer (counts equal)."""
import os

import numpy as np
import pytest
import torch

from vgan_tpu.graph.packed import PackedGraph as JaxGraph
from vgan_tpu.mapper.giraffe import BatchedMapper as JaxMapper
from vgan_tpu.parallel import mesh as jax_mesh
from vgan_tpu.pipelines import euka as jax_euka
from vgan_tpu.pipelines import haplocart_runner as jax_runner
from vgan_tpu_torch import bench

import bench as jax_bench

torch.set_num_threads(1)

RTOL = 1e-12
SMOKE = bench.Sizes.of(True)


@pytest.fixture
def single_device_mesh():
    """Cap the JAX auto mesh at one device, restoring the cap after."""
    prev = jax_mesh._DEVICE_LIMIT
    jax_mesh.set_device_limit(1)
    try:
        yield
    finally:
        jax_mesh.set_device_limit(prev)


def _jax_graph(graph):
    return JaxGraph(**{f: getattr(graph, f) for f in (
        "min_id", "node_seq_pool", "node_off", "edge_from", "edge_from_rev",
        "edge_to", "edge_to_rev", "path_names", "path_steps_node",
        "path_steps_rev", "path_support")})


def test_hc_toy_e2e_equals_jax_run_sample(tmp_path, single_device_mesh):
    """bench_haplocart_e2e on the toy world (400 reads of haplotype 5)
    against vgan_tpu's run_sample on the same graph, DB (bench.py's
    _db_from_graph) and reads."""
    b = bench.Bench("cpu", SMOKE)
    r = bench.bench_haplocart_e2e(b)
    graph, _db, _mapper, reads = b.toy()
    assert r["agree"] and r["pred"] == "hap5"
    assert len(r["runs"]) == 5 and len(r["host_runs"]) == 3

    jgraph = _jax_graph(graph)
    fq = bench.write_fastq(os.path.join(tmp_path, "r.fq"), reads)
    cfg = jax_runner.HaplocartConfig(db_dir="", fq1=fq, quiet=True)
    jpred, _n, jvec = jax_runner.run_sample(
        cfg, jax_bench._db_from_graph(jgraph),
        JaxMapper(jgraph, k=31, w=11), "bench")
    assert r["pred"] == jpred
    assert np.isfinite(r["vec"]).all()
    np.testing.assert_allclose(r["vec"], jvec, rtol=RTOL)


def test_euka_realdb_counts_equal_jax():
    """bench_euka_realdb's last streamed result on the 8-taxon smoke
    world against vgan_tpu's EukaScorer.score_table_stream over its
    mapper's chunks, with bench.py's gates."""
    b = bench.Bench("cpu", SMOKE)
    r = bench.bench_euka_realdb(b)
    graph, clades, chunks, reads = bench.euka_realdb_world(SMOKE)
    assert r["taxa"] == 8 and len(reads) == 200
    assert len(r["runs"]) == 5 and len(r["map_runs"]) == 3

    jgraph = _jax_graph(graph)
    jclades = [jax_euka.CladeInfo(**vars(c)) for c in clades]
    scorer = jax_euka.EukaScorer(jgraph, jclades, chunks)
    want = scorer.score_table_stream(
        JaxMapper(jgraph, k=20, w=10).map_table_chunks(reads),
        min_mq=0, min_frag=1, min_bins=1, max_bins=21)
    got = r["result"]
    assert int(got.counts.sum()) > 0
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    assert got.detected == want.detected
