"""The port's tree MCMC (vgan_tpu_torch/infer/tree_mcmc.py, plain torch
versions on the CPU) against the JAX package's, in f64.

Inputs are made with numpy from a seed: trees as inline Newick strings
(a polytomy, a three-child root, leaves at several depths, so that the
walk meets leaf and root bounces, parent moves and sibling moves),
random path_map / counts25 tables. The samplers get the JAX package's
own noise and initial proportions through the port's `draw_noise` /
`init_theta`. Node ids must be identical; floats agree to rtol 1e-12
(torch and XLA evaluate exp, log and the sums over reads in another
order). The JAX side keeps to a few shapes, so that its compiles stay
few."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgan_tpu.infer import tree_mcmc as jax_tm
from vgan_tpu.pipelines import soibean as jax_sb
from vgan_tpu.utils.newick import parse_newick as jax_parse
from vgan_tpu_torch.infer import tree_mcmc as tm
from vgan_tpu_torch.utils.newick import parse_newick

torch.set_num_threads(1)

RTOL = 1e-12
CPU = torch.device("cpu")
# a three-child root, a polytomy (N1) and leaves at three depths
NEWICK = ("((A:0.2,B:0.25,C:0.1)N1:0.3,((D:0.22,E:0.18)N2:0.28,G:0.4)N3:0.1,"
          "F:0.05)R;")
FREQS = jax_sb.make_freqs(0.3, 0.2, 0.22, 0.28)


def jax_keys(seeds):
    return jax.vmap(jax.random.PRNGKey)(
        jnp.asarray(np.asarray(seeds), jnp.uint32))


def jax_noise(seeds, i0, i1, k, hops, device):
    """tm.draw_noise's stand-in: the JAX package's counter-keyed noise of
    the same rows and iterations."""
    out = jax_tm._gen_noise_batch(jax_keys(seeds), jnp.arange(i0, i1), k=k,
                                  hops=hops)
    return tm.Noise(*(torch.from_numpy(np.array(x)).to(device) for x in out))


def jax_theta(seeds, k, device):
    """tm.init_theta's stand-in: the JAX package's starting proportions."""
    th = jax.vmap(functools.partial(jax_tm._init_theta_for_key, k=k))(
        jax_keys(seeds))
    return torch.from_numpy(np.array(th, dtype=np.float64)).to(device)


@pytest.fixture
def jax_streams(monkeypatch):
    monkeypatch.setattr(tm, "draw_noise", jax_noise)
    monkeypatch.setattr(tm, "init_theta", jax_theta)


def _world(newick=NEWICK, R=30, seed=5):
    """(tree, path_map [R, N], counts25 [R, N, 25]): reads that prefer
    two leaves, integer counts."""
    tree = parse_newick(newick)
    N = tree.n_nodes
    rng = np.random.default_rng(seed)
    leaves = np.nonzero(tree.n_children == 0)[0]
    path_map = np.full((R, N), -40.0)
    path_map[: R // 2, leaves[0]] = -20.0
    path_map[R // 2 :, leaves[-1]] = -22.0
    path_map += rng.uniform(-0.5, 0.5, size=(R, N))
    counts25 = rng.integers(0, 4, size=(R, N, 25)).astype(np.float32)
    return tree, path_map, counts25


def _assert_trace(got, want):
    np.testing.assert_array_equal(got.node, want.node)
    for f in ("pos", "theta", "loglike"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)


# ------------------------------------------------------------- pieces
def test_hky25_sd_schedule_and_hops_equal_jax():
    freq = tm.freq_tensor(FREQS, CPU)
    ts = np.array([0.0, 1e-5, 0.01, 0.05, 0.3, 2.0])
    for con in (0.01, 0.1, 0.3):
        got = tm.hky25(torch.from_numpy(ts), con, freq).numpy()
        for i, t in enumerate(ts):
            want = np.asarray(jax_tm.hky25(t, con, FREQS))
            np.testing.assert_allclose(got[i], want, rtol=RTOL,
                                       err_msg=f"t={t} con={con}")
    for max_iter, burn, paths in ((300, 60, 9), (1000, 1, 40), (7, 7, 400),
                                  (250000, 75000, 31)):
        np.testing.assert_array_equal(
            tm.sd_schedule(max_iter, burn, paths),
            jax_tm.sd_schedule(max_iter, burn, paths))
    for paths in (1, 9, 30, 31, 60, 100, 400):
        assert tm.burn_walk_hops(paths) == jax_tm.burn_walk_hops(paths)


@pytest.mark.parametrize("newick", [
    NEWICK,
    # a caterpillar: a deep walk to the root and long sibling runs
    "((((A:0.1,B:0.2)N1:0.15,C:0.3)N2:0.05,D:0.25)N3:0.2,E:0.12)R;",
], ids=["polytomy", "caterpillar"])
def test_update_position_equals_jax(newick):
    """2,000 random moves (sd up to 4 branch lengths, both directions,
    every node, positions at the branch ends included): nodes exact,
    positions to rtol 1e-12."""
    tree = parse_newick(newick)
    N = tree.n_nodes
    M, hops = 2000, 20
    rng = np.random.default_rng(N)
    node = rng.integers(0, N, size=M).astype(np.int32)
    pos = rng.uniform(0.0, 1.0, size=M)
    pos[:50] = 1e-12
    pos[50:100] = 1.0 - 1e-10
    delta = (rng.standard_normal(M).astype(np.float32).astype(np.float64)
             * rng.choice([0.05, 0.5, 1.5, 4.0], size=M))
    walk_u = rng.random((M, hops, 4), dtype=np.float32)
    jt = jax_parse(newick)
    tt = jax_tm.pack_tree_table(jax_tm.TreeArrays(
        jnp.asarray(jt.parent), jnp.asarray(jt.dist),
        jnp.asarray(jt.children), jnp.asarray(jt.n_children)))
    fn = jax.jit(jax.vmap(functools.partial(jax_tm.update_position, tt)))
    wn, wp = fn(jnp.asarray(node), jnp.asarray(pos),
                jnp.asarray(np.abs(delta)), jnp.asarray(delta >= 0),
                jnp.asarray(walk_u))
    gn, gp = tm.update_position(
        tm.tree_tensors(tree, CPU), torch.from_numpy(node),
        torch.from_numpy(pos), torch.from_numpy(np.abs(delta)),
        torch.from_numpy(delta >= 0), torch.from_numpy(walk_u))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=RTOL)
    # the moves reach every node, leaves and root included
    assert set(gn.numpy().tolist()) == set(range(N))
    assert (gn.numpy() != node).mean() > 0.3


def test_run_segment_plain_equals_jax():
    """k = 1..3 rows padded to Kmax = 3 with a mask: 60 burn-in steps
    (20 hops, iteration 0 included), then 40 steps of 8 hops from the
    carry; JAX's noise drawn once for both."""
    tree, path_map, counts25 = _world()
    con = 0.05
    B, K = 6, 3
    rng = np.random.default_rng(1)
    mask = np.zeros((B, K), bool)
    for b in range(B):
        mask[b, : b % 3 + 1] = True
    nodes = rng.integers(0, tree.n_nodes, size=(B, K)).astype(np.int32)
    nodes[~mask] = 0
    theta = np.where(mask, rng.random((B, K)) + 0.1, 0.0)
    theta /= theta.sum(1, keepdims=True)
    ll = np.full(B, -700.0)
    seeds = np.arange(B) + 11
    sd = tm.sd_schedule(99, 60, tree.n_nodes)
    data = tm.prepare(tree, path_map, counts25, FREQS, con, CPU)
    jargs = (jnp.asarray(path_map), jnp.asarray(counts25),
             jnp.asarray(tree.parent), jnp.asarray(tree.dist),
             jnp.asarray(tree.children), jnp.asarray(tree.n_children),
             jnp.asarray(con),
             jnp.asarray([FREQS[n] for n in tm.FREQ_KEYS]))
    carry_j = (jnp.asarray(nodes), jnp.full((B, K), 0.5), jnp.asarray(theta),
               jnp.asarray(ll))
    carry_t = (torch.from_numpy(nodes), torch.full((B, K), 0.5,
                                                   dtype=torch.float64),
               torch.from_numpy(theta), torch.from_numpy(ll))
    for i0, i1, hops in ((0, 60, 20), (60, 100, 8)):
        iters = jnp.arange(i0, i1)
        noise = jax_tm._gen_noise_batch(jax_keys(seeds), iters, k=K,
                                        hops=hops)
        carry_j, rec_j = jax_tm._run_segment_batch(
            *carry_j, jnp.asarray(mask), iters, jnp.asarray(sd[i0:i1]),
            noise, *jargs, walk_hops=hops)
        carry_t, rec_t = tm.run_segment(
            *carry_t, torch.from_numpy(mask), torch.arange(i0, i1),
            torch.from_numpy(sd[i0:i1]),
            tm.Noise(*(torch.from_numpy(np.array(x)) for x in noise)),
            data.path_map_t, data.counts25_t, data.tree, data.con, data.freq)
        np.testing.assert_array_equal(rec_t[0].numpy(), np.asarray(rec_j[0]))
        for got, want in zip(rec_t[1:], rec_j[1:]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL)
    np.testing.assert_array_equal(carry_t[0].numpy(), np.asarray(carry_j[0]))
    for got, want in zip(carry_t[1:], carry_j[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    # the padded slots keep theta == 0, each row's theta sums to 1
    rec_theta = rec_t[2].numpy()
    assert (rec_theta[~np.broadcast_to(mask[:, None], rec_theta.shape)]
            == 0).all()
    np.testing.assert_allclose(rec_theta.sum(-1), 1.0, rtol=1e-12)
    # chains moved and some proposals were rejected
    acc = np.diff(rec_t[3].numpy(), axis=1) != 0
    assert 0 < acc.mean() < 1


# ------------------------------------------------------------- runners
RUN = dict(con=0.05, max_iter=240, burn=60)


def test_chains_and_ksweep_equal_jax(jax_streams):
    """The chains runner and the k-sweep (k = 1, 2) against JAX's with
    JAX's noise and initial proportions injected."""
    tree, path_map, counts25 = _world()
    jtree = jax_parse(NEWICK)
    N = tree.n_nodes
    leaves = np.nonzero(tree.n_children == 0)[0]
    srcs1 = np.array([[leaves[0]], [3]], dtype=np.int32)
    srcs2 = np.array([[leaves[0], leaves[-1]], [2, 5]], dtype=np.int32)
    seeds1, seeds2 = np.array([3, 4]), np.array([40, 41])
    kw = dict(RUN, num_paths=N)
    got = tm.run_tree_mcmc_chains(
        tree, path_map, counts25, srcs2, FREQS, init_loglike=-650.0,
        seeds=seeds2, device="cpu", **kw)
    want = jax_tm.run_tree_mcmc_chains(
        jtree, path_map, counts25, srcs2, FREQS, init_loglike=-650.0,
        seeds=seeds2, **kw)
    _assert_trace(got, want)
    # the one-chain runner is the chains runner's row of its seed (to
    # rtol 1e-12: torch's batched reductions may sum a row in another
    # order at another batch size)
    one = tm.run_tree_mcmc(tree, path_map, counts25, srcs2[1], FREQS,
                           init_loglike=-650.0, seed=41, device="cpu", **kw)
    _assert_trace(one, tm.MCMCTrace(*(x[1] for x in got)))
    sweep = tm.run_tree_mcmc_ksweep(
        tree, path_map, counts25, [srcs1, srcs2], FREQS,
        init_logls=[-600.0, -650.0], seeds_per_k=[seeds1, seeds2],
        device="cpu", **kw)
    jsweep = jax_tm.run_tree_mcmc_ksweep(
        jtree, path_map, counts25, [srcs1, srcs2], FREQS,
        init_logls=[-600.0, -650.0], seeds_per_k=[seeds1, seeds2], **kw)
    for g, w in zip(sweep, jsweep):
        _assert_trace(g, w)
    # a k == Kmax row of the sweep is the standalone chain
    _assert_trace(sweep[1], got)
    np.testing.assert_allclose(sweep[0].theta, 1.0)


def test_checkpointed_equals_jax(jax_streams, tmp_path):
    tree, path_map, counts25 = _world()
    kw = dict(RUN, num_paths=tree.n_nodes, init_loglike=-600.0, seed=7)
    src = np.array([2, 6], dtype=np.int32)
    got = tm.run_tree_mcmc_checkpointed(
        tree, path_map, counts25, src, FREQS, device="cpu",
        checkpoint_path=str(tmp_path / "c"), checkpoint_every=100, **kw)
    want = jax_tm.run_tree_mcmc_checkpointed(
        jax_parse(NEWICK), path_map, counts25, src, FREQS,
        checkpoint_path=str(tmp_path / "j"), checkpoint_every=100, **kw)
    _assert_trace(got, want)
    # the port does not resume a checkpoint of the JAX package
    with pytest.raises(ValueError, match="format"):
        tm.run_tree_mcmc_checkpointed(
            tree, path_map, counts25, src, FREQS, device="cpu",
            checkpoint_path=str(tmp_path / "j"), checkpoint_every=100, **kw)


# -------------------------------------------------- the port's own noise
def test_killed_and_resumed_run_equals_uninterrupted(tmp_path, monkeypatch):
    tree, path_map, counts25 = _world()
    kw = dict(RUN, num_paths=tree.n_nodes, init_loglike=-600.0, seed=9,
              device="cpu", checkpoint_every=70)
    src = np.array([1, 4], dtype=np.int32)
    straight = tm.run_tree_mcmc_checkpointed(
        tree, path_map, counts25, src, FREQS, checkpoint_path=None, **kw)
    orig, calls = tm.run_segment, {"n": 0}

    def bomb(*a, **k):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt
        return orig(*a, **k)

    ckpt = str(tmp_path / "chain")
    monkeypatch.setattr(tm, "run_segment", bomb)
    with pytest.raises(KeyboardInterrupt):
        tm.run_tree_mcmc_checkpointed(tree, path_map, counts25, src, FREQS,
                                      checkpoint_path=ckpt, **kw)
    monkeypatch.setattr(tm, "run_segment", orig)
    z = np.load(ckpt + ".npz")
    assert str(z["format"]) == tm.CHECKPOINT_FORMAT
    assert 0 < int(z["next_iter"]) < RUN["max_iter"] + 1
    resumed = tm.run_tree_mcmc_checkpointed(
        tree, path_map, counts25, src, FREQS, checkpoint_path=ckpt, **kw)
    for f in MCMC_FIELDS:
        np.testing.assert_array_equal(getattr(resumed, f),
                                      getattr(straight, f), err_msg=f)


MCMC_FIELDS = ("node", "pos", "theta", "loglike")


def test_trace_independent_of_segment_size(monkeypatch):
    """Segments of 1 KiB (a few iterations) and of the default 64 MiB,
    with noise blocks of 16 iterations, give the same k-sweep trace; a
    k == Kmax row equals the standalone chains runner."""
    monkeypatch.setattr(tm, "NOISE_BLOCK", 16)
    tree, path_map, counts25 = _world()
    srcs1 = np.array([[0], [4]], dtype=np.int32)
    srcs2 = np.array([[0, 5], [4, 1]], dtype=np.int32)
    kw = dict(RUN, num_paths=tree.n_nodes, device="cpu")
    sweeps, plans = [], []
    for seg in (1024, 64 << 20):
        monkeypatch.setattr(tm, "SEGMENT_BYTES", seg)
        sweeps.append(tm.run_tree_mcmc_ksweep(
            tree, path_map, counts25, [srcs1, srcs2], FREQS,
            init_logls=[-600.0, -650.0], seeds_per_k=[[1, 2], [3, 4]],
            **kw))
        plans.append(tm.segment_plan(RUN["max_iter"] + 1, RUN["burn"],
                                     tree.n_nodes, 4, 2))
    for a, b in zip(*sweeps):
        for f in MCMC_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(plans[0]) > 50 and len(plans[1]) == 2
    assert plans[0][-1][1] == RUN["max_iter"] + 1
    alone = tm.run_tree_mcmc_chains(
        tree, path_map, counts25, srcs2, FREQS, init_loglike=-650.0,
        seeds=[3, 4], **kw)
    for f in MCMC_FIELDS:
        np.testing.assert_array_equal(getattr(sweeps[1][1], f),
                                      getattr(alone, f))


def test_noise_and_theta_streams():
    """Each row's noise depends on its seed and iteration only; the
    starting proportions are a point of the simplex."""
    a = tm.draw_noise([5, 6], 1000, 1100, 3, 8, "cpu")
    b = tm.draw_noise([6], 1050, 1060, 3, 8, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x[1, 50:60], y[0])
    assert a.walk_u.shape == (2, 100, 3, 8, 4) and a.acc_u.shape == (2, 100)
    assert float(a.walk_u.min()) >= 0.0 and float(a.walk_u.max()) < 1.0
    assert not torch.equal(a.deltas[0], a.deltas[1])
    th = tm.init_theta([1, 2, 3], 4, "cpu")
    assert th.dtype == torch.float64 and (th > 0).all()
    np.testing.assert_allclose(th.sum(1).numpy(), 1.0, rtol=1e-15)
    assert torch.equal(tm.init_theta([2], 4, "cpu")[0], th[1])


def test_counts_dtype_and_layout():
    tree, path_map, counts25 = _world()
    assert tm.counts_dtype(counts25, "cpu") == torch.float64
    # on the card: the smallest integer type that holds the counts
    assert tm.counts_dtype(counts25, "cuda") == torch.uint8
    assert tm.counts_dtype(counts25 * 100, "cuda") == torch.int16
    assert tm.counts_dtype(counts25 * 1e5, "cuda") == torch.float64
    assert tm.counts_dtype(counts25 + 0.5, "cuda") == torch.float64
    data = tm.prepare(tree, path_map, counts25, FREQS, 0.05, "cpu")
    assert data.path_map_t.shape == (tree.n_nodes, 30)
    np.testing.assert_array_equal(data.counts25_t.numpy(),
                                  counts25.transpose(1, 0, 2))


# clusters of G CTAs an H100 SXM (132 SMs, seven or eight GPCs) holds at
# once, and a smaller card's
H100_RESIDENT = {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}
SMALL_RESIDENT = {16: 0, 8: 2, 4: 5, 2: 10, 1: 20}


@pytest.mark.parametrize("B,n_sm,resident,want", [
    (1, 132, H100_RESIDENT, 16), (4, 132, H100_RESIDENT, 16),
    (12, 132, H100_RESIDENT, 8), (40, 132, H100_RESIDENT, 2),
    (132, 132, H100_RESIDENT, 1), (200, 132, H100_RESIDENT, 1),
    (1, 20, SMALL_RESIDENT, 8), (4, 20, SMALL_RESIDENT, 4),
    (12, 20, SMALL_RESIDENT, 1), (40, 20, SMALL_RESIDENT, 1),
])
def test_cluster_size(B, n_sm, resident, want):
    """The largest of 16, 8, 4, 2, 1 CTAs a row whose B clusters are all
    resident at once on distinct SMs (the card's residency query
    injected); never more clusters than the card holds."""
    asked = []

    def query(G):
        asked.append(G)
        return resident[G]

    got = tm.cluster_size(B, n_sm, query)
    assert got == want
    fits = tm.cluster_sizes(B, n_sm, resident.__getitem__)
    assert fits[0] == got and fits[-1] == 1
    assert fits == sorted(fits, reverse=True)
    assert got in tm.CLUSTER_SIZES
    if got > 1:
        assert B * got <= n_sm and resident[got] >= B
    larger = [G for G in tm.CLUSTER_SIZES if G > got]
    assert all(B * G > n_sm or resident[G] < B for G in larger)
    assert 1 not in asked  # plain blocks need no query
