"""The round algorithm of csrc/abundance_mcmc.cu (a window of proposals
from one state), as a torch model on the CPU, held to the sequential
chain: `run_segment_plain` and the JAX package's `_run_seg` fed the same
noise.

A round evaluates the d proposals of steps s0 .. s0 + d - 1 from the
state at s0, takes the first that accepts (j*), records rows
s0 .. s0 + j*, moves the state to step j*'s proposal and starts the
next round at s0 + j* + 1 (at s0 + d when nothing accepts). The model
computes each proposal as the kernel does for T <= 8 (max, sum and
log-likelihood serial over the taxa) and takes exp and log through
torch's scalar loop, so a step's bits do not depend on where it sits in
a window: any d, and segments cut anywhere, give the same bits.

Held on a grid of T in {1, 3, 16, 40}, d in {1, 2, 7, 32, 256}, low- and
high-acceptance chains, and the edge chains (const_ll = -inf; a taxon
with no reads whose proposal underflows: 0 * log(0) = NaN rejects), to
rtol 1e-12 (torch's and XLA's exp / log, and another order of the sums,
differ in the last bits) and with the same accepted steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgan_tpu.infer import abundance_mcmc as jax_am
from vgan_tpu_torch.infer import abundance_mcmc as port_am

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-12
ALPHA = 0.1
START_LL = port_am.START_LL
S_GRID = 400
TS = [1, 3, 16, 40]
WINDOWS = [1, 2, 7, 32, 256]


# ------------------------------------------------------------ the model
def _scalar(fn, x):
    """fn(x) through torch's scalar loop (a strided view of x), so an
    element's bits do not depend on its place in the tensor."""
    buf = torch.empty(x.shape + (2,), dtype=x.dtype)
    buf[..., 0] = x
    return fn(buf[..., 0])


def _proposals(logc, cll, z, u, n_reads, const_ll):
    """The proposals of the rows of z [w, T] from the state (logc, cll):
    (prop, log(prop), ll, accept), each row as the kernel computes it."""
    x = logc + ALPHA * z
    mx = x[:, 0]
    for t in range(1, x.shape[1]):
        mx = torch.maximum(mx, x[:, t])  # NaN propagates
    e = _scalar(torch.exp, x - mx[:, None])
    total = torch.zeros(x.shape[0], dtype=F64)
    for t in range(x.shape[1]):
        total = total + e[:, t]
    prop = e / total[:, None]
    lp = _scalar(torch.log, prop)
    ll = torch.zeros(x.shape[0], dtype=F64)
    for t in range(x.shape[1]):
        ll = ll + n_reads[t] * lp[:, t]
    ll = ll + const_ll
    ratio = _scalar(torch.exp, ll - cll)
    # u <= min(1, NaN) is false: a NaN ratio rejects
    accept = u <= torch.minimum(torch.ones((), dtype=F64), ratio)
    return prop, lp, ll, accept


def window_chain(current, cur_ll, z, u, n_reads, const_ll, d):
    """S steps in rounds of d proposals from one state. Returns
    ((state, ll), proposals [S, T], accepted steps)."""
    S = z.shape[0]
    out = torch.empty_like(z)
    logc, cll = _scalar(torch.log, current), cur_ll.clone()
    s0, accepted = 0, []
    while s0 < S:
        e = min(s0 + d, S)
        prop, lp, ll, accept = _proposals(logc, cll, z[s0:e], u[s0:e],
                                          n_reads, const_ll)
        hits = torch.nonzero(accept).flatten()
        j = int(hits[0]) if len(hits) else e - s0 - 1
        out[s0:s0 + j + 1] = prop[:j + 1]
        if len(hits):
            logc, cll = lp[j], ll[j]
            accepted.append(s0 + j)
        s0 += j + 1
    state = out[accepted[-1]].clone() if accepted else current.clone()
    return (state, cll), out, accepted


# ------------------------------------------------------------ the chains
def _inputs(T, kind, seed):
    """n_reads, const_ll and init of a chain over T taxa: `low` with
    thousands of reads a taxon (few accepts), `high` with a handful (most
    steps accept)."""
    rng = np.random.default_rng(seed)
    if kind == "low":  # started at the posterior's mode
        n = rng.integers(2000, 8000, size=T).astype(np.float64)
        return n, -5.0 * T, n / n.sum()
    n = rng.integers(0, 5, size=T).astype(np.float64)
    init = rng.gamma(1.0, size=T)
    return n, -5.0 * T, init / init.sum()


EDGE = {
    # const_ll = -inf: -inf - START_LL rejects every proposal
    "neg_inf_const": (np.array([40.0, 10.0, 5.0]), -np.inf,
                      np.array([0.5, 0.3, 0.2])),
    # a taxon with no reads and no share: its proposal underflows to 0,
    # 0 * log(0) = NaN, and a NaN ratio rejects
    "nan_ratio": (np.array([60.0, 0.0, 25.0]), -3.0,
                  np.array([0.6, 0.0, 0.4])),
    # a taxon with no reads but a share: its share drifts freely
    "zero_reads": (np.array([60.0, 0.0, 25.0, 5.0]), -12.5,
                   np.array([0.4, 0.2, 0.3, 0.1])),
}


def _torch_args(n, const, init):
    return (torch.from_numpy(np.asarray(init, np.float64)),
            torch.tensor(START_LL, dtype=F64),
            torch.from_numpy(np.asarray(n, np.float64)),
            torch.tensor(const, dtype=F64))


def _noise(S, T, seed):
    z, u = port_am.draw_noise(S, T, seed)
    return z, u


def _jax_noise(S, T, seed):
    """The keys of a JAX segment and the noise its steps draw."""
    keys = jax.random.split(jax.random.PRNGKey(seed), S)

    def one(key):
        kp, ku = jax.random.split(key)
        return (jax.random.normal(kp, (T,), dtype=jnp.float64),
                jax.random.uniform(ku, dtype=jnp.float64))

    z, u = jax.vmap(one)(keys)
    return keys, torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def plain_chain(current, cur_ll, z, u, n_reads, const_ll):
    """run_segment_plain: ((state, ll), proposals, accepted steps), the
    steps replayed from its proposals (accepted_steps)."""
    (state, ll), props = port_am.run_segment_plain(current, cur_ll, z, u,
                                                   ALPHA, n_reads, const_ll)
    steps, _margins = port_am.accepted_steps(props, u, n_reads, const_ll,
                                             cur_ll)
    return (state, ll), props, steps


def jax_chain(init, n, const, keys, u):
    """JAX's _run_seg: (state, ll, proposals, accepted steps)."""
    f = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    (state, ll), props = jax_am._run_seg(f(init), f(START_LL), keys,
                                         f(ALPHA), f(n), f(const))
    props = np.array(props)
    steps, _margins = port_am.accepted_steps(
        torch.from_numpy(props), u, torch.from_numpy(np.asarray(n)),
        torch.tensor(const, dtype=F64), torch.tensor(START_LL, dtype=F64))
    return np.asarray(state), float(ll), props, steps


@functools.lru_cache(maxsize=None)
def _grid_plain(T, kind):
    n, const, init = _inputs(T, kind, seed=T)
    cur, ll0, n_t, c_t = _torch_args(n, const, init)
    z, u = _noise(S_GRID, T, seed=10 * T + len(kind))
    return (cur, ll0, z, u, n_t, c_t), plain_chain(cur, ll0, z, u, n_t, c_t)


@functools.lru_cache(maxsize=None)
def _grid_jax(T, kind):
    n, const, init = _inputs(T, kind, seed=T)
    keys, z, u = _jax_noise(S_GRID, T, seed=20 * T + len(kind))
    return (n, const, init, z, u), jax_chain(init, n, const, keys, u)


def _assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=0)


# ------------------------------------------------------------ the tests
def test_chains_have_the_acceptance_they_are_named_for():
    """The grid's chains: `low` accepts under 15 % of its steps and
    `high` over half at every T > 1; at T = 1 the proposal is always 1,
    and every step accepts."""
    for T in TS:
        low = len(_grid_plain(T, "low")[1][2]) / S_GRID
        high = len(_grid_plain(T, "high")[1][2]) / S_GRID
        if T == 1:
            assert low == high == 1.0
        else:
            assert 0 < low < 0.15 and high > 0.5, (T, low, high)


@pytest.mark.parametrize("kind", ["low", "high"])
@pytest.mark.parametrize("d", WINDOWS)
@pytest.mark.parametrize("T", TS)
def test_window_model_equals_plain(T, d, kind):
    """Proposals, state and likelihood to rtol 1e-12 of
    run_segment_plain, with the same accepted steps."""
    args, ((ps, pl), pp, pacc) = _grid_plain(T, kind)
    (ms, ml), mp, macc = window_chain(*args, d=d)
    assert macc == pacc
    _assert_close(mp, pp)
    _assert_close(ms, ps)
    _assert_close(ml, pl)


@pytest.mark.parametrize("kind", ["low", "high"])
@pytest.mark.parametrize("d", WINDOWS)
@pytest.mark.parametrize("T", TS)
def test_window_model_equals_jax_run_seg(T, d, kind):
    """JAX's noise injected: proposals, state and likelihood to rtol
    1e-12 of JAX's _run_seg, with the same accepted steps."""
    (n, const, init, z, u), (js, jl, jp, jacc) = _grid_jax(T, kind)
    cur, ll0, n_t, c_t = _torch_args(n, const, init)
    (ms, ml), mp, macc = window_chain(cur, ll0, z, u, n_t, c_t, d=d)
    assert macc == jacc
    _assert_close(mp, jp)
    _assert_close(ms, js)
    _assert_close(float(ml), jl)


@pytest.mark.parametrize("d", [1, 7, 32])
@pytest.mark.parametrize("case", sorted(EDGE))
def test_window_model_edge_chains(case, d):
    """The edge chains against run_segment_plain and JAX's _run_seg:
    const_ll = -inf and the underflowing taxon never accept; the zero-read
    taxon's chain moves."""
    n, const, init = EDGE[case]
    S, T = 300, len(n)
    cur, ll0, n_t, c_t = _torch_args(n, const, init)
    z, u = _noise(S, T, seed=7)
    (ps, pl), pp, pacc = plain_chain(cur, ll0, z, u, n_t, c_t)
    (ms, ml), mp, macc = window_chain(cur, ll0, z, u, n_t, c_t, d=d)
    assert macc == pacc
    _assert_close(mp, pp)
    _assert_close(ms, ps)
    _assert_close(ml, pl)
    keys, jz, ju = _jax_noise(S, T, seed=8)
    js, jl, jp, jacc = jax_chain(init, n, const, keys, ju)
    (ms, ml), mp, macc = window_chain(cur, ll0, jz, ju, n_t, c_t, d=d)
    assert macc == jacc
    _assert_close(mp, jp)
    _assert_close(ms, js)
    if case == "zero_reads":
        assert macc and float(ml) != START_LL
    else:  # never accepted
        assert not macc and float(ml) == START_LL
        assert torch.equal(ms, cur)


@pytest.mark.parametrize("S,d", [(1, 32), (5, 32), (31, 32), (33, 32),
                                 (100, 7), (255, 256)])
def test_window_model_short_and_ragged_segments(S, d):
    """S < d and S not a multiple of d: the window is cut at the
    segment's end."""
    n, const, init = _inputs(3, "low", seed=S)
    cur, ll0, n_t, c_t = _torch_args(n, const, init)
    z, u = _noise(S, 3, seed=S + d)
    (ps, pl), pp, pacc = plain_chain(cur, ll0, z, u, n_t, c_t)
    (ms, ml), mp, macc = window_chain(cur, ll0, z, u, n_t, c_t, d=d)
    assert mp.shape == (S, 3) and macc == pacc
    _assert_close(mp, pp)
    _assert_close(ms, ps)
    _assert_close(ml, pl)


@pytest.mark.parametrize("kind", ["low", "high"])
@pytest.mark.parametrize("d", [2, 7, 32, 256])
def test_window_model_segments_ending_mid_window_equal_one_segment(d, kind):
    """Segments whose ends fall inside a window, the carry passed on as
    the checkpointed runner passes it (the last accepted proposal and its
    likelihood), give the one-segment run's bits."""
    T = 3
    args, _plain = _grid_plain(T, kind)
    cur, ll0, z, u, n_t, c_t = args
    (ws, wl), whole, wacc = window_chain(*args, d=d)
    cuts = [0, d // 2 + 1, d + 3, 3 * d + 1, S_GRID]
    cuts = sorted({min(c, S_GRID) for c in cuts})
    carry, parts, acc = (cur, ll0), [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        carry, part, seg_acc = window_chain(*carry, z[a:b], u[a:b], n_t, c_t,
                                            d=d)
        parts.append(part)
        acc += [a + s for s in seg_acc]
    assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(carry[0], ws) and torch.equal(carry[1], wl)
    assert acc == wacc


@pytest.mark.parametrize("T", TS)
def test_window_model_same_bits_for_every_window(T):
    """Every d gives the same bits: a step's arithmetic depends only on
    the state and its own noise."""
    args, _plain = _grid_plain(T, "low")
    runs = [window_chain(*args, d=d) for d in WINDOWS]
    for (s, ll), p, acc in runs[1:]:
        (s0, ll0), p0, acc0 = runs[0]
        assert acc == acc0
        assert torch.equal(p, p0) and torch.equal(s, s0)
        assert torch.equal(ll, ll0)
