"""Port's euka pieces against the JAX package, on the CPU in f64: the
damage-table gather, the per-base two-model scorer, the scorer's three
entry points on a 3-taxon world, and the abundance MCMC fed the JAX
package's own noise.

Float results are held to rtol 1e-12 (torch and XLA evaluate log, exp
and the sums in another order); integers, lists and the detected set
must be identical. The JAX scorer runs with its auto mesh capped at one
device (the test conftest gives JAX 8 virtual CPU devices)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world as world
from vgan_tpu.graph import synth as jax_synth
from vgan_tpu.graph.packed import PackedGraph as JaxGraph
from vgan_tpu.infer import abundance_mcmc as jax_am
from vgan_tpu.models import damage as jax_damage
from vgan_tpu.models import phred as jax_phred
from vgan_tpu.parallel import mesh as jax_mesh
from vgan_tpu.pipelines import euka as jax_ek
from vgan_tpu_torch.graph import synth as port_synth
from vgan_tpu_torch.graph.packed import PackedGraph as PortGraph
from vgan_tpu_torch.infer import abundance_mcmc as port_am
from vgan_tpu_torch.mapper.giraffe import BatchedMapper as PortMapper
from vgan_tpu_torch.models import damage as port_damage
from vgan_tpu_torch.pipelines import euka as port_ek

torch.set_num_threads(1)

RTOL = 1e-12
GATES = dict(min_mq=29, min_frag=10, min_bins=4, max_bins=0,
             entropy_threshold=1.17)


@pytest.fixture
def single_device_mesh():
    prev = jax_mesh._DEVICE_LIMIT
    jax_mesh.set_device_limit(1)
    try:
        yield
    finally:
        jax_mesh.set_device_limit(prev)


def _write_random_prof(path, rng, n_rows):
    """A 12-column profile with random small rates (rows sum < 1)."""
    with open(path, "w") as f:
        f.write(world.PROF_HEADER)
        for _ in range(n_rows):
            f.write("\t".join(f"{x:.6f}" for x in rng.random(12) * 0.08)
                    + "\n")


def _damage_pair(tmp_path, which, seed=0):
    """(JAX DamageModel, port DamageModel) from the same profiles."""
    rng = np.random.default_rng(seed)
    p5 = p3 = None
    if which in ("both", "5p"):
        p5 = str(tmp_path / "d5.prof")
        _write_random_prof(p5, rng, 7)
    if which == "both":
        p3 = str(tmp_path / "d3.prof")
        _write_random_prof(p3, rng, 4)
    return (jax_damage.DamageModel.from_profiles(p5, p3),
            port_damage.DamageModel.from_profiles(p5, p3))


@pytest.mark.parametrize("which", ["both", "5p", "none"])
def test_dinuc_gather_matches_jax(tmp_path, which):
    jdm, pdm = _damage_pair(tmp_path, which)
    np.testing.assert_array_equal(pdm.sub5p, jdm.sub5p)
    np.testing.assert_array_equal(pdm.sub3p, jdm.sub3p)
    rng = np.random.default_rng(1)
    # in range and out of range on both sides of the 1,000-row tables
    L = rng.integers(-5, 1100, size=(64, 1)).astype(np.int32)
    l = rng.integers(-20, 1200, size=(64, 33)).astype(np.int32)
    j5, j3 = jdm.tables(jnp.float64)
    want = np.asarray(jax_damage.dinuc_gather(j5, j3, jnp.asarray(L),
                                              jnp.asarray(l)))
    p5, p3 = pdm.tables("cpu")
    assert p5.dtype == torch.float64
    got = port_damage.dinuc_gather(p5, p3, torch.from_numpy(L),
                                   torch.from_numpy(l)).numpy()
    assert got.shape == (64, 33, 4, 4)
    np.testing.assert_array_equal(got, want)
    # the host oracle agrees at a few points
    for b, i in ((0, 0), (5, 17), (63, 32)):
        if 1 <= L[b, 0] <= 1000 and 0 <= l[b, i] < L[b, 0]:
            np.testing.assert_array_equal(got[b, i],
                                          jdm.dinuc(L[b, 0], l[b, i]))


def _random_score_inputs(rng, B=96, L=48):
    g = rng.integers(0, 8, size=(B, L)).astype(np.int32)
    r = np.where(rng.random((B, L)) < 0.7, g,
                 rng.integers(0, 8, size=(B, L))).astype(np.int32)
    # runs of softclips, so the every-third-position rule is exercised
    r[: B // 4, 5:17] = 6
    q = rng.integers(0, 121, size=(B, L)).astype(np.int32)
    n_pos = rng.integers(-30, 1100, size=(B, L)).astype(np.int32)
    L_read = rng.integers(1, 1001, size=B).astype(np.int32)
    pair_dist = rng.random(B) * 0.2
    valid = np.arange(L)[None, :] < rng.integers(0, L + 1, size=B)[:, None]
    return g, r, q, n_pos, L_read, pair_dist, valid


@pytest.mark.parametrize("which", ["both", "none"])
def test_score_batch_matches_jax(tmp_path, which):
    jdm, pdm = _damage_pair(tmp_path, which, seed=3)
    arrays = _random_score_inputs(np.random.default_rng(4))
    j5, j3 = jdm.tables(jnp.float64)
    want = jax_ek._score_batch(
        *(jnp.asarray(a) for a in arrays), j5, j3,
        jnp.asarray(jax_phred.qscore_vec()), jnp.asarray(jax_ek.BASE_FREQ_LOG),
        jnp.asarray(jax_ek.T_T_RATIO))
    p5, p3 = pdm.tables("cpu")
    got = port_ek.score_batch(
        *(torch.from_numpy(a) for a in arrays), p5, p3,
        torch.from_numpy(port_ek.phred.qscore_vec()),
        torch.from_numpy(port_ek.BASE_FREQ_LOG),
        torch.from_numpy(port_ek.T_T_RATIO))
    for gv, wv in zip(got, want):
        assert gv.dtype == torch.float64
        assert np.isfinite(gv.numpy()).all()
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL)


# ------------------------------------------------------------ 3-taxon world
@pytest.fixture(scope="module")
def taxa(tmp_path_factory):
    """tests/test_euka_e2e.py's 3-taxon world, built in each package,
    the port's mapper's tables (one-shot and in chunks of 128) for a
    140/40/20 read mixture, and a damage profile pair."""
    out = tmp_path_factory.mktemp("taxa")
    pgraph, ranges = world.build_euka_graph(port_synth, PortGraph)
    jgraph, jranges = world.build_euka_graph(jax_synth, JaxGraph)
    assert ranges == jranges
    np.testing.assert_array_equal(pgraph.node_seq_pool, jgraph.node_seq_pool)
    chunks = world.euka_bins(ranges)
    dists = [0.03 + 0.02 * t for t in range(3)]
    _d, d5, d3 = world.write_euka_db(out, pgraph, ranges, 2, dists, chunks)
    reads = world.write_mixture_fastq(port_synth, pgraph, out / "r.fq",
                                      [(0, 140), (1, 40), (2, 20)], 2)
    mapper = PortMapper(pgraph, k=20, w=10, device="cpu")
    table = mapper.map_reads_table(reads)
    parts = list(mapper.map_table_chunks(reads, chunk=128))
    assert len(parts) == 2
    return dict(pgraph=pgraph, jgraph=jgraph, chunks=chunks, dists=dists,
                ranges=ranges, table=table, parts=parts, d5=d5, d3=d3)


def _clades(mod, taxa):
    return [mod.CladeInfo(t, f"Taxon{t}", taxa["dists"][t], 2, lo, hi)
            for t, (lo, hi) in enumerate(taxa["ranges"])]


def assert_results_equal(got, want):
    assert [vars(c) for c in got.clades] == [vars(c) for c in want.clades]
    assert got.chunks == want.chunks
    for f in ("counts", "n_mapped", "baseshift"):
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert got.detected == want.detected
    assert got.insert_sizes == want.insert_sizes
    assert got.frag_names == want.frag_names
    assert [len(x) for x in got.clade_like] == [len(x) for x in want.clade_like]
    for a, b in zip(got.clade_like, want.clade_like):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    for a, b in zip(got.coverage, want.coverage):
        np.testing.assert_allclose(a, b, rtol=RTOL)


@pytest.mark.parametrize("entry", ["score", "score_table",
                                   "score_table_stream"])
def test_euka_scorer_matches_jax(taxa, single_device_mesh, entry):
    jdm = jax_damage.DamageModel.from_profiles(taxa["d5"], taxa["d3"])
    pdm = port_damage.DamageModel.from_profiles(taxa["d5"], taxa["d3"])
    js = jax_ek.EukaScorer(taxa["jgraph"], _clades(jax_ek, taxa),
                           taxa["chunks"], damage=jdm)
    ps = port_ek.EukaScorer(taxa["pgraph"], _clades(port_ek, taxa),
                            taxa["chunks"], damage=pdm, device="cpu")
    if entry == "score":
        alns = taxa["table"].to_alignments()
        want, got = js.score(alns, **GATES), ps.score(alns, **GATES)
    elif entry == "score_table":
        want = js.score_table(taxa["table"], **GATES)
        got = ps.score_table(taxa["table"], **GATES)
    else:
        want = js.score_table_stream(iter(taxa["parts"]), **GATES)
        got = ps.score_table_stream(iter(taxa["parts"]), **GATES)
    assert got.detected == [0, 1, 2]
    assert list(got.counts) == [140, 40, 20]
    assert_results_equal(got, want)


# ------------------------------------------------------------ MCMC
def jax_noise(n: int, T: int, seed: int):
    """The per-iteration noise of the JAX package's chain: key i of
    split(PRNGKey(seed), n), then split(key) -> normal(kp, (T,)),
    uniform(ku) in f64, exactly as its `_run_seg` step draws it."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)

    def one(key):
        kp, ku = jax.random.split(key)
        return (jax.random.normal(kp, (T,), dtype=jnp.float64),
                jax.random.uniform(ku, dtype=jnp.float64))

    z, u = jax.vmap(one)(keys)
    return (torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u)))


def test_jax_noise_is_the_scan_noise():
    """The batched draw above equals the per-key draw of `_run_seg`."""
    z, u = jax_noise(5, 3, 11)
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    for i in range(5):
        kp, ku = jax.random.split(keys[i])
        np.testing.assert_array_equal(
            z[i].numpy(),
            np.asarray(jax.random.normal(kp, (3,), dtype=jnp.float64)))
        assert float(u[i]) == float(jax.random.uniform(ku, dtype=jnp.float64))


CHAINS = {
    "three": (np.array([300, 100, 50]),
              np.array([300 * np.log(0.95), 100 * np.log(0.9),
                        50 * np.log(0.85)]),
              np.array([0.4, 0.35, 0.25])),
    # a zero clade_like makes the sum of logs -inf: proposals are never
    # accepted but still recorded
    "zero_like": (np.array([10, 10]), np.array([-np.inf, 10 * np.log(0.9)]),
                  np.array([0.6, 0.4])),
}


def assert_mcmc_equal(got, want):
    assert got.samples.shape == want.samples.shape
    np.testing.assert_allclose(got.samples, want.samples, rtol=RTOL)
    for f in ("estimate", "ci85", "ci95"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_run_mcmc_matches_jax(monkeypatch, chain):
    n, slog, init = CHAINS[chain]
    kw = dict(n_iter=1500, burnin=100, seed=7)
    want = jax_am.run_mcmc(n, slog, init, **kw)
    monkeypatch.setattr(port_am, "draw_noise", jax_noise)
    got = port_am.run_mcmc(n, slog, init, device="cpu", **kw)
    assert got.samples.shape == (1500 - 101, len(n))
    assert_mcmc_equal(got, want)
    if chain == "zero_like":
        # never accepted: every proposal is drawn around init
        prop0 = torch.softmax(torch.log(torch.from_numpy(init))
                              + 0.1 * jax_noise(1500, 2, 7)[0][101], -1)
        np.testing.assert_allclose(got.samples[0], prop0.numpy(), rtol=RTOL)


def test_run_mcmc_checkpointed_matches_jax(monkeypatch, tmp_path):
    n, slog, init = CHAINS["three"]
    kw = dict(n_iter=1500, burnin=100, seed=3, checkpoint_every=400)
    want = jax_am.run_mcmc_checkpointed(
        n, slog, init, checkpoint_path=str(tmp_path / "jax"), **kw)
    monkeypatch.setattr(port_am, "draw_noise", jax_noise)
    got = port_am.run_mcmc_checkpointed(
        n, slog, init, checkpoint_path=str(tmp_path / "port"), device="cpu",
        **kw)
    assert os.path.exists(tmp_path / "port.npz")
    assert_mcmc_equal(got, want)


def test_port_checkpointed_resumes_exactly(monkeypatch, tmp_path):
    """A run broken after two segments resumes from its snapshot to the
    straight run's trace, bit for bit (the port's own noise)."""
    n, slog, init = CHAINS["three"]
    kw = dict(n_iter=2500, burnin=100, seed=7)
    straight = port_am.run_mcmc(n, slog, init, device="cpu", **kw)
    ckpt = str(tmp_path / "ab")
    segmented = port_am.run_mcmc_checkpointed(
        n, slog, init, checkpoint_path=ckpt, checkpoint_every=700,
        device="cpu", **kw)
    assert os.path.exists(ckpt + ".npz")
    np.testing.assert_array_equal(segmented.samples, straight.samples)

    real = port_am.run_segment
    calls = {"n": 0}

    def dying(*a, **k):
        if calls["n"] >= 2:
            raise KeyboardInterrupt
        calls["n"] += 1
        return real(*a, **k)

    ckpt2 = str(tmp_path / "ab2.npz")
    monkeypatch.setattr(port_am, "run_segment", dying)
    with pytest.raises(KeyboardInterrupt):
        port_am.run_mcmc_checkpointed(
            n, slog, init, checkpoint_path=ckpt2, checkpoint_every=700,
            device="cpu", **kw)
    monkeypatch.setattr(port_am, "run_segment", real)
    with np.load(ckpt2) as snap:
        assert int(snap["next_iter"]) == 1400
    resumed = port_am.run_mcmc_checkpointed(
        n, slog, init, checkpoint_path=ckpt2, checkpoint_every=700,
        device="cpu", **kw)
    np.testing.assert_array_equal(resumed.samples, straight.samples)
    np.testing.assert_array_equal(resumed.estimate, straight.estimate)


def test_draw_noise_is_seeded_and_f64():
    z, u = port_am.draw_noise(50, 4, 9)
    z2, u2 = port_am.draw_noise(50, 4, 9)
    assert z.dtype == u.dtype == torch.float64
    assert z.shape == (50, 4) and u.shape == (50,)
    assert torch.equal(z, z2) and torch.equal(u, u2)
    assert not torch.equal(z, port_am.draw_noise(50, 4, 10)[0])
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
