"""euka's abundance chain and HaploCart's likelihood step, the port's two
functions that launch csrc/abundance_mcmc.cu and csrc/haplocart.cu on a
card, held on the CPU (where they run their plain versions) against the
JAX package in f64:

* the chain: `run_segment` on CPU tensors is `run_segment_plain` bit for
  bit; fed the JAX package's own noise it matches `_run_seg` to rtol
  1e-12 (XLA's and torch's exp/log differ in the last bit) on the edge
  chains the kernel must get right;
* the likelihood step: `node_scores` on pack_batch's views equals it on
  the same rows as an HcBatch exactly, and sum(b) + c @ support matches
  JAX's `score_packed` / `score_batch` to rtol 1e-12 (another order of the
  f64 sums) on rows that exercise every clamp, with consensus off and on;
  the split scorer and the multi-process scorer go through it;
* the CUDA sources export the entry points the wrappers bind, with as
  many parameters as the wrappers pass.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world as world
from vgan_tpu.graph import synth as jax_synth
from vgan_tpu.infer import abundance_mcmc as jax_am
from vgan_tpu.pipelines import haplocart_device as jax_hcd
from vgan_tpu.pipelines import haplocart_runner as jax_runner
from vgan_tpu_torch import _native
from vgan_tpu_torch.infer import abundance_mcmc as port_am
from vgan_tpu_torch.parallel import mesh as port_mesh
from vgan_tpu_torch.parallel import multihost as port_mh
from vgan_tpu_torch.pipelines import haplocart_device as port_hcd
from vgan_tpu_torch.pipelines import haplocart_runner as port_runner
from vgan_tpu_torch.pipelines.hc_columnar import _bucket_M, pack_batch

torch.set_num_threads(1)

RTOL = 1e-12
START_LL = port_am.START_LL


# ------------------------------------------------------------ the chain
def _jax_keys_noise(S, T, seed):
    """The keys of a JAX segment and the noise its steps draw from them
    (split(key) -> normal(kp, (T,)), uniform(ku), f64)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), S)

    def one(key):
        kp, ku = jax.random.split(key)
        return (jax.random.normal(kp, (T,), dtype=jnp.float64),
                jax.random.uniform(ku, dtype=jnp.float64))

    z, u = jax.vmap(one)(keys)
    return keys, torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def _dirichlet(rng, T):
    x = rng.gamma(1.0, size=T)
    return x / x.sum()


# name: (n_reads [T], const_ll, init [T], steps)
CHAINS = {
    # a clade_like of 0: const_ll = -inf, so -inf - START_LL rejects
    # every proposal; the proposals are drawn around init throughout
    "neg_inf_const": (np.array([40.0, 10.0, 5.0]), -np.inf,
                      np.array([0.5, 0.3, 0.2]), 400),
    # a detected taxon with no reads: its share drifts freely
    "zero_reads": (np.array([60.0, 0.0, 25.0, 5.0]), -12.5,
                   np.array([0.4, 0.2, 0.3, 0.1]), 400),
    # no reads and a zero share: prop = 0 there, 0 * log(0) = NaN, and
    # a NaN ratio rejects (fmin(1, NaN) would accept)
    "nan_ratio": (np.array([60.0, 0.0, 25.0]), -3.0,
                  np.array([0.6, 0.0, 0.4]), 300),
    "T1": (np.array([17.0]), -2.0, np.array([1.0]), 300),
    "T2": (np.array([120.0, 30.0]), -40.0, np.array([0.5, 0.5]), 400),
    "T334": ("random", -1500.0, "random", 200),
    "S1": (np.array([300.0, 100.0, 50.0]), -20.0,
           np.array([0.4, 0.35, 0.25]), 1),
}


def _chain_inputs(name):
    n, const, init, S = CHAINS[name]
    if isinstance(n, str):
        rng = np.random.default_rng(334)
        n = rng.integers(0, 400, size=334).astype(np.float64)
        init = _dirichlet(rng, 334)
    return n, const, init, S


@pytest.mark.parametrize("T", [1, 3, 40])
def test_run_segment_on_cpu_is_the_plain_version(T):
    rng = np.random.default_rng(T)
    n = torch.from_numpy(rng.integers(0, 200, size=T).astype(np.float64))
    init = torch.from_numpy(_dirichlet(rng, T))
    z = torch.from_numpy(rng.standard_normal((250, T)))
    u = torch.from_numpy(rng.random(250))
    const = torch.tensor(-7.5, dtype=torch.float64)
    ll0 = torch.tensor(START_LL, dtype=torch.float64)
    port_am.reset_launches()
    (s1, l1), p1 = port_am.run_segment(init, ll0, z, u, 0.1, n, const)
    (s2, l2), p2 = port_am.run_segment_plain(init, ll0, z, u, 0.1, n, const)
    assert port_am.LAUNCHES["abundance_mcmc_segment"] == 0
    assert torch.equal(p1, p2) and torch.equal(s1, s2)
    assert torch.equal(l1, l2)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_run_segment_matches_jax_run_seg(name):
    """Proposals and the carried state to rtol 1e-12 against the JAX
    scan fed the same keys; NaN-free where JAX's are."""
    n, const, init, S = _chain_inputs(name)
    T = len(n)
    keys, z, u = _jax_keys_noise(S, T, seed=len(name))
    (js, jl), jprops = jax_am._run_seg(
        jnp.asarray(init, jnp.float64), jnp.asarray(START_LL, jnp.float64),
        keys, jnp.asarray(0.1, jnp.float64), jnp.asarray(n, jnp.float64),
        jnp.asarray(const, jnp.float64))
    (ps, pl), pprops = port_am.run_segment(
        torch.from_numpy(init), torch.tensor(START_LL, dtype=torch.float64),
        z, u, 0.1, torch.from_numpy(n),
        torch.tensor(const, dtype=torch.float64))
    assert pprops.shape == (S, T)
    np.testing.assert_allclose(pprops.numpy(), np.asarray(jprops), rtol=RTOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=RTOL)
    np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)
    if name in ("neg_inf_const", "nan_ratio"):  # never accepted
        assert float(pl) == START_LL and np.array_equal(ps.numpy(), init)
    else:
        assert float(pl) != START_LL  # the chain moved


# ------------------------------------------------------------ likelihood step
N_NODES, N_PATHS = 300, 64


@pytest.fixture(scope="module")
def hc_tables():
    """JAX's f64 tables over a synthetic support, and the port's copies."""
    support = jax_hcd.synth_support(n_nodes=N_NODES, n_paths=N_PATHS)
    jt = jax_hcd.make_tables(support, jnp.float64)
    pt = port_hcd.tables_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in jt._fields}, "cpu")
    return jt, pt


def _edge_batch(seed, S=8):
    a = world.hc_edge_arrays(np.random.default_rng(seed), N_NODES,
                             port_hcd.mutation.PANGENOME_LEN, S=S)
    M = _bucket_M(len(a["b"]))
    return a, M, pack_batch(a, np.float64)


def _hc_batch(cols, consensus):
    batch = port_hcd.HcBatch(**{k: torch.from_numpy(v)
                                for k, v in cols.items()})
    if consensus:
        batch.use_bep = torch.ones_like(batch.use_bep)
    return batch


@pytest.mark.parametrize("consensus", [False, True])
def test_node_scores_packed_views_equal_batch(hc_tables, consensus):
    """The packed buffer's views and an HcBatch of the same padded rows
    give the same c and sum(b), bit for bit."""
    _jt, pt = hc_tables
    a, M, buf = _edge_batch(3)
    buf_t = torch.from_numpy(buf)
    views = port_hcd.unpack(buf_t, M, a["S"])
    for x in (views.g, views.take, views.b):  # views, not copies
        assert (x.untyped_storage().data_ptr()
                == buf_t.untyped_storage().data_ptr())
    c1, b1 = port_hcd.node_scores(views, pt, 1e-4, consensus)
    c2, b2 = port_hcd.node_scores(
        _hc_batch(world.hc_padded_columns(a, M), consensus), pt, 1e-4,
        consensus)
    assert c1.shape == (N_NODES,) and torch.isfinite(c1).all()
    assert torch.equal(c1, c2) and torch.equal(b1, b2)


@pytest.mark.parametrize("consensus", [False, True])
def test_node_scores_matches_jax_score_packed(hc_tables, consensus):
    """sum(b) + c @ support against JAX's score_packed on one buffer, and
    the port's score_packed (which goes through node_scores) with it."""
    jt, pt = hc_tables
    a, M, buf = _edge_batch(5)
    want = np.asarray(jax_hcd.score_packed(
        jnp.asarray(buf), jt, jnp.float64(1e-4), M=M, S=a["S"],
        consensus=consensus))
    c, total_b = port_hcd.node_scores(
        port_hcd.unpack(torch.from_numpy(buf), M, a["S"]), pt, 1e-4,
        consensus)
    got = (total_b + c @ pt.support).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    port_hcd.reset_launches()
    packed = port_hcd.score_packed(torch.from_numpy(buf), pt, 1e-4, M=M,
                                   S=a["S"], consensus=consensus).numpy()
    assert port_hcd.LAUNCHES["hc_node_scores"] == 0  # CPU: no kernel
    np.testing.assert_allclose(packed, want, rtol=RTOL)


def _counting(monkeypatch):
    calls = []
    real = port_hcd.node_scores

    def spy(*a, **k):
        calls.append(a[0].g.shape[0])
        return real(*a, **k)

    monkeypatch.setattr(port_hcd, "node_scores", spy)
    return calls


@pytest.mark.parametrize("consensus", [False, True])
def test_split_scorer_goes_through_node_scores(hc_tables, monkeypatch,
                                               consensus):
    """score_batch_split over three CPU devices: one node_scores a part,
    the result JAX's score_batch on the whole batch (rtol 1e-12)."""
    jt, pt = hc_tables
    a, M, _buf = _edge_batch(9)
    cols = world.hc_padded_columns(a, M)
    jb = jax_hcd.HcBatch(**{k: jnp.asarray(v) for k, v in cols.items()})
    if consensus:
        jb = jb._replace(use_bep=jnp.ones_like(jb.use_bep))
    want = np.asarray(jax_hcd.score_batch(jb, jt, jnp.float64(1e-3),
                                          consensus=consensus))
    calls = _counting(monkeypatch)
    got = port_mesh.score_batch_split(_hc_batch(cols, consensus), [pt] * 3,
                                      1e-3, consensus)
    assert calls == [342, 342, 340]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.fixture(scope="module")
def hc_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("hc")
    _graph, db_dir, fq, _reads = world.build(jax_synth, out)
    return db_dir, fq


def test_multihost_scorer_goes_through_node_scores(hc_world, monkeypatch):
    """score_alignments_multihost in one process (no group: no
    all-reduce) scores its alignments with one node_scores, equal to
    JAX's device scorer on the same alignments (rtol 1e-12)."""
    from vgan_tpu_torch.io.fastx import read_fastq

    db_dir, fq = hc_world
    pdb = port_runner.load_db(db_dir, "cpu")
    mapper = port_runner.Mapper(pdb.graph, k=31, w=11, device="cpu")
    alns = [a for a in mapper.map_reads(read_fastq(fq)[:120])
            if a.identity != 0]
    alns = port_runner.hc.remove_duplicates(port_runner.gamsort(alns))
    calls = _counting(monkeypatch)
    got = port_mh.score_alignments_multihost(pdb, alns)
    assert len(calls) == 1
    want = jax_hcd.score_alignments_device(jax_runner.load_db(db_dir), alns,
                                           mesh=None)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert int(np.argmax(got)) == int(np.argmax(want))


# ------------------------------------------------------------ the sources
def _c_params(src, fn):
    """The parameter count of `int fn(...)` in the extern "C" block."""
    text = open(src).read()
    block = text[text.index('extern "C" {'):]
    m = re.search(r"int\s+" + fn + r"\s*\(([^)]*)\)\s*\{", block)
    assert m, f"{fn} not defined in the extern \"C\" block of {src}"
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("src,fn,kernel,argtypes", [
    (_native.ABUNDANCE_MCMC_SRC, "abundance_mcmc_segment_launch",
     "abundance_mcmc_segment_kernel", _native.ABUNDANCE_MCMC_ARGTYPES),
    (_native.HAPLOCART_SRC, "hc_node_scores_launch", "hc_node_scores_kernel",
     _native.HC_NODE_SCORES_ARGTYPES),
])
def test_kernel_sources_export_the_bound_symbols(src, fn, kernel, argtypes):
    assert os.path.exists(src)
    assert _c_params(src, fn) == len(argtypes)
    assert re.search(r"__global__ void .*\b" + kernel + r"\(",
                     open(src).read())
