"""euka's per-base scorer as euka_score_kernel (csrc/euka.cu) computes it,
modelled in torch f64 on the CPU and held against the JAX package:

* `onelog_model`, the kernel's arithmetic: an ACGT column's m1 as one log
  of sum_d max(post_d, 1e-300) err_d (the JAX package takes the
  logsumexp of the logs), a softclip column's single log or log1p, the
  softclip count carried mod 3 across the kernel's chunks (4 G columns, G
  lanes a row) and spans (S columns a CTA of a cluster, the count before a
  span counted from column 0), and each row summed in the kernel's order
  (a lane's columns, a butterfly over the G lanes, the spans in rank
  order). Against `_score_batch` in f64 on every case of
  _torch_world.euka_score_cases at rtol 1e-12, NaN and infinities in the
  same rows;
* the ACGT term alone against JAX's logsumexp form on edge values: NaN,
  +inf, negative and clamped posts, qv of 0, 1 and qtab's smallest (a
  subnormal product), and random columns: the same NaN and infinities,
  elsewhere within 1e-13 absolute or 2e-12 relative a column (this model
  on these columns: 1.1e-13 absolute at |m1| ~ 690, 1.6e-14 relative);
* the softclip count of the model's chunks and spans against the plain
  cumsum for every row width class the kernel has (G = 8, 16, 32; one
  span and clusters of 2 to 8);
* the model's geometry read from the kernel's constants, and the kernel
  library's C entry points against their ctypes argument types;
* score_batch's [2, B] result on the CPU, and the split path's.

The kernel itself is held to score_batch_plain on the card by
tests/test_torch_cuda.py."""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world as world
from vgan_tpu.pipelines import euka as jax_ek
from vgan_tpu_torch import _native
from vgan_tpu_torch.models import phred as port_phred
from vgan_tpu_torch.parallel import mesh as port_mesh
from vgan_tpu_torch.pipelines import euka as port_ek

torch.set_num_threads(1)

RTOL = 1e-12
COL_ATOL, COL_RTOL = 1e-13, 2e-12
CASES = world.euka_score_cases(port_phred.qscore_vec(), port_ek.BASE_FREQ_LOG,
                               port_ek.T_T_RATIO)
SRC = open(_native.EUKA_SRC).read()


def _const(name):
    return int(re.search(r"constexpr int " + name + r" = (\d+);",
                         SRC).group(1))


THREADS, SPAN, MAX_CLUSTER = (_const("kThreads"), _const("kChunkCols"),
                              _const("kMaxCluster"))
SMEM, ROW_STRIDE, QCAP, MAX_READS = (_const("kSmemBytes"),
                                     _const("kRowStride"), _const("kQCap"),
                                     _const("kMaxReads"))
H100_SMS = 132  # the SMs of an H100 SXM, which sets the passes a CTA


def kernel_geometry(L):
    """(G, S, nc) of csrc/euka.cu's geometry(): lanes a row, columns a
    CTA takes of a row, CTAs a cluster."""
    G = 32 if L > 64 else (16 if L > 32 else 8)
    if G < 32:
        return G, 4 * G, 1
    spans = -(-L // SPAN)
    per_cta = -(-spans // MAX_CLUSTER)
    return G, per_cta * SPAN, -(-spans // per_cta)


def acgt_onelog(post, e_hit, e_miss, r4):
    """log(sum_d max(post_d, 1e-300) err_d), err_d = e_hit where d == r4
    else e_miss; the sum left to right over d."""
    p = torch.where(post < 1e-300, torch.full_like(post, 1e-300), post)
    s = None
    for d in range(4):
        e = torch.where(r4 == d, e_hit, e_miss)
        s = p[..., d] * e if s is None else s + p[..., d] * e
    return torch.log(s)


def soft_count_mod3(soft, G, S):
    """The inclusive softclip count of each column mod 3 as the kernel
    carries it: per span of S columns the count before it (from column
    0), then per chunk of 4 G columns the span's count so far, the lanes
    below and the lane's own columns."""
    B, L = soft.shape
    chunk = 4 * G
    out = torch.zeros((B, L), dtype=torch.int64)
    for lo in range(0, L, S):
        local = soft[:, :lo].sum(1) % 3
        for c0 in range(lo, min(L, lo + S), chunk):
            w = min(L, c0 + chunk) - c0
            blk = torch.zeros((B, chunk), dtype=torch.int64)
            blk[:, :w] = soft[:, c0:c0 + w]
            lanes = blk.view(B, G, 4)
            lane_tot = lanes.sum(-1)
            below = torch.cumsum(lane_tot, 1) - lane_tot
            cnt = (local[:, None, None] + below[..., None]
                   + torch.cumsum(lanes, -1)) % 3
            out[:, c0:c0 + w] = cnt.view(B, chunk)[:, :w]
            local = (local + lane_tot.sum(1)) % 3
    return out


def kernel_order_sum(m, valid, G, S, nc):
    """Row sums of m over the valid columns in the kernel's order: each
    lane its columns (chunk by chunk, four a chunk), a butterfly over the
    G lanes, then the nc spans in rank order."""
    B, L = m.shape
    chunk = 4 * G
    lanes = torch.zeros((B, nc, G), dtype=torch.float64)
    for k in range(nc):
        for c0 in range(k * S, k * S + S, chunk):
            for j in range(4):
                cols = c0 + 4 * torch.arange(G) + j
                inside = cols < L
                cc = torch.where(inside, cols, 0)
                ok = valid[:, cc] & inside
                lanes[:, k] = torch.where(ok, lanes[:, k] + m[:, cc],
                                          lanes[:, k])
    o = G // 2
    while o > 0:
        lanes = lanes + lanes[..., torch.arange(G) ^ o]
        o //= 2
    t = lanes[:, 0, 0]
    for k in range(1, nc):
        t = t + lanes[:, k, 0]
    return t


def onelog_model(g, r, q, n_pos, L_read, pair_dist, valid, sub5p, sub3p,
                 qtab, bfreq, ttr):
    """(il, nl) of score_batch's arguments (torch CPU tensors) by the
    kernel's arithmetic (see the module docstring)."""
    B, L = g.shape
    G, S, nc = kernel_geometry(L)
    g, r, q, n_pos = (x.long() for x in (g, r, q, n_pos))
    qv = qtab[q.clamp(0, qtab.shape[0] - 1)]
    e_hit, e_miss = 1.0 - qv, qv / 3.0
    is_n = (g == 4) | (r == 4)
    is_gap = ~is_n & ((g == 5) | (r == 5))
    is_rare = ~is_n & ~is_gap & ((g == 7) | (r == 7))
    is_soft = ~is_n & ~is_gap & ~is_rare & ((g == 6) | (r == 6))
    pd = pair_dist[:, None]
    g4, r4 = g.clamp(0, 3), r.clamp(0, 3)
    eye = torch.arange(4)
    pre = torch.where(g4[..., None] == eye, 1.0 - pd[..., None],
                      pd[..., None] * ttr[g4])
    maxlen = sub5p.shape[0]
    l5 = n_pos.clamp(0, maxlen - 1)
    wrap = (L_read.long()[:, None] - n_pos - 1 + 2**31) % 2**32 - 2**31
    l3 = wrap.clamp(0, maxlen - 1)
    f5, f3 = sub5p[l5], sub3p[l3]
    use5 = torch.diagonal(f5, dim1=-2, dim2=-1) <= torch.diagonal(
        f3, dim1=-2, dim2=-1)
    D = torch.where(use5[..., None], f5, f3)
    post = None
    for o in range(4):
        t = pre[..., o, None] * D[..., o, :]
        post = t if post is None else post + t
    m1_acgt = acgt_onelog(post, e_hit, e_miss, r4)
    third = soft_count_mod3(is_soft.long(), G, S) == 0
    m1_soft = torch.where(third, torch.log1p(-qv), torch.log(e_miss))
    bf = bfreq[torch.where(r < 0, r + bfreq.shape[0], r).clamp(
        0, bfreq.shape[0] - 1)]
    full = lambda v: torch.full((B, L), v, dtype=torch.float64)  # noqa: E731
    rare_m1 = torch.log((1.0 - pd) * 0.001).expand(B, L)
    m2_acgt = torch.where(g == r, full(math.log(1.0 - 0.25536)),
                          full(math.log(0.25536)))
    m1 = torch.where(is_n, bf, torch.where(is_gap, full(math.log(0.002)),
                     torch.where(is_rare, rare_m1,
                                 torch.where(is_soft, m1_soft, m1_acgt))))
    m2 = torch.where(is_n, bf, torch.where(is_gap, full(math.log(0.2)),
                     torch.where(is_rare, full(math.log(0.001)),
                                 torch.where(is_soft, full(math.log(0.25)),
                                             m2_acgt))))
    return (kernel_order_sum(m1, valid, G, S, nc),
            kernel_order_sum(m2, valid, G, S, nc))


def _jax_scores(arrays, tables):
    il, nl = jax_ek._score_batch(*(jnp.asarray(a) for a in arrays),
                                 *(jnp.asarray(t) for t in tables))
    return np.asarray(il), np.asarray(nl)


def _same_specials(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isposinf(got), np.isposinf(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_onelog_model_matches_jax(case):
    arrays, tables = CASES[case]
    want = _jax_scores(arrays, tables)
    got = onelog_model(*(torch.from_numpy(a) for a in arrays),
                       *(torch.from_numpy(t) for t in tables))
    for gv, wv in zip(got, want):
        gv = gv.numpy()
        assert gv.shape == (arrays[0].shape[0],)
        _same_specials(gv, wv)
        np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=0)


def test_onelog_model_at_long_rows_split_over_a_cluster():
    """Rows of 1,024 columns (eight spans) with softclip runs across
    spans, and of 1,025 (spans of 256 columns): the model against JAX."""
    rng = np.random.default_rng(11)
    for L in (1024, 1025):
        d = world._euka_rows(rng, 12, L)
        d["r"][::3, 100:700] = 6
        d["g"][1::3, 120:130] = 6
        d["valid"][1::3, 300:900] = False
        arrays, tables = world._euka_case(d, world.euka_damage_tables(rng) + [
            port_phred.qscore_vec(), port_ek.BASE_FREQ_LOG,
            port_ek.T_T_RATIO])
        want = _jax_scores(arrays, tables)
        got = onelog_model(*(torch.from_numpy(a) for a in arrays),
                           *(torch.from_numpy(t) for t in tables))
        for gv, wv in zip(got, want):
            np.testing.assert_allclose(gv.numpy(), wv, rtol=RTOL, atol=0)


def _jax_acgt(post, qv, r4):
    """JAX's ACGT term (vgan_tpu/pipelines/euka.py:146-150) on posts."""
    post, qv, r4 = jnp.asarray(post), jnp.asarray(qv), jnp.asarray(r4)
    eye = jnp.arange(4)
    err = jnp.where(r4[..., None] == eye, 1.0 - qv[..., None],
                    qv[..., None] / 3.0)
    return np.asarray(jax.scipy.special.logsumexp(
        jnp.log(jnp.maximum(post, 1e-300)) + jnp.log(err), axis=-1))


def _edge_columns():
    """(post [n, 4], qv [n], r4 [n]): every combination of edge posts,
    edge qualities and r4, and 20,000 random columns."""
    qtab = port_phred.qscore_vec()
    edge_posts = [
        [np.nan, 0.5, 0.2, 0.1], [0.5, np.nan, np.nan, 0.1],
        [np.inf, 0.1, 0.1, 0.1], [np.inf, np.inf, 0.0, 0.0],
        [-0.5, 0.9, 0.05, 0.05], [-1.0, -2.0, -np.inf, 0.0],
        [0.0, 0.0, 0.0, 0.0], [1e-310, 1e-305, 1e-300, 1e-299],
        [1e-300, 1e-300, 1e-300, 1e-300], [1.0, 0.0, 0.0, 0.0],
        [0.97, 0.01, 0.01, 0.01], [0.25, 0.25, 0.25, 0.25],
        [2.0, 1e-20, 1e-200, 3.0], [np.inf, np.nan, 1.0, 1.0],
    ]
    edge_q = [0.0, 1.0, float(qtab.min()), float(qtab[qtab > 0].min()),
              float(qtab.max()), 0.5, 1e-300]
    rows = [(p, qv, r4) for p in edge_posts for qv in edge_q
            for r4 in range(4)]
    rng = np.random.default_rng(5)
    n = 20000
    rand_post = rng.dirichlet(np.ones(4) * 0.3, size=n) * rng.uniform(
        0.5, 1.0, size=(n, 1))
    rand_post[rng.random((n, 4)) < 0.05] = 1e-300 * rng.random()
    rand_q = qtab[rng.integers(0, len(qtab), size=n)]
    posts = np.concatenate([np.array([p for p, _q, _r in rows]), rand_post])
    qv = np.concatenate([np.array([q for _p, q, _r in rows]), rand_q])
    r4 = np.concatenate([np.array([r for _p, _q, r in rows]),
                         rng.integers(0, 4, size=n)])
    return posts, qv, r4


def test_acgt_onelog_matches_jax_logsumexp_at_edge_values():
    post, qv, r4 = _edge_columns()
    want = _jax_acgt(post, qv, r4)
    qt = torch.from_numpy(qv)
    got = acgt_onelog(torch.from_numpy(post), 1.0 - qt, qt / 3.0,
                      torch.from_numpy(r4)).numpy()
    _same_specials(got, want)
    fin = np.isfinite(want)
    assert fin.sum() > 20000 and (~fin).sum() > 50
    err = np.abs(got[fin] - want[fin])
    assert (err <= np.maximum(COL_ATOL, COL_RTOL * np.abs(want[fin]))).all()
    # a subnormal product among them: all posts clamped, qv / 3 tiny
    tiny = (qv > 0) & (qv < 1e-9)
    assert tiny.any() and np.isfinite(want[tiny]).any()


@pytest.mark.parametrize("L", [0, 1, 3, 32, 33, 64, 65, 77, 128, 129, 300,
                               1023, 1024, 1025, 2100])
def test_soft_count_carried_mod3_equals_cumsum(L):
    """The model's chunk and span carry (the kernel's G, S and nc for L)
    against JAX's cumsum(is_soft) % 3, on softclips at 0-90 % density,
    in runs and alone."""
    rng = np.random.default_rng(L)
    B = 9
    soft = rng.random((B, L)) < np.linspace(0, 0.9, B)[:, None]
    if L > 40:
        soft[0, 10:40] = True
    G, S, nc = kernel_geometry(L)
    assert nc * S >= L and (nc == 1 or (nc - 1) * S < L)
    got = soft_count_mod3(torch.from_numpy(soft).long(), G, S)
    want = np.cumsum(soft, axis=1) % 3
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("L,want", [(0, (8, 32, 1)), (1, (8, 32, 1)),
                                    (32, (8, 32, 1)), (33, (16, 64, 1)),
                                    (64, (16, 64, 1)), (65, (32, 128, 1)),
                                    (1023, (32, 128, 8)),
                                    (1024, (32, 128, 8)),
                                    (1025, (32, 256, 5))])
def test_kernel_geometry_from_the_source(L, want):
    assert THREADS == 256 and SPAN == 128 and MAX_CLUSTER == 8
    assert kernel_geometry(L) == want


def staging_rounds(n_pos, L_read, valid, maxlen, sms=H100_SMS):
    """The rounds in which each CTA of the kernel's launch stages its
    damage-table rows, as csrc/euka.cu's range pass decides them: 1 where
    the rows of all its valid columns fit its staged slots at once, 2
    where they fit one row class at a time (a warp a row, G = 32; a row's
    class 0 where its 5' rows lie no farther from its columns than its 3'
    rows), 0 where it reads them through L1 or holds no valid column."""
    B, L = n_pos.shape
    G, S, nc = kernel_geometry(L)
    rpp = THREADS // G
    if nc > 1:
        P = 2
    else:
        P = MAX_READS // rpp
        while P > 1 and -(-B // (rpp * P)) * nc < 3 * sms:
            P //= 2
    R = rpp * P
    fixed = (R * (16 + 1 + 2 * MAX_CLUSTER) * 8 + QCAP * 16
             + (THREADS // 32) * 8 * 4 + R * 4)
    cap = min(((SMEM - fixed) // (8 * ROW_STRIDE)) & ~3,
              (2 * maxlen + 3) & ~3)
    n = n_pos.astype(np.int64)
    l5 = np.clip(n, 0, maxlen - 1)
    wrap = (L_read[:, None].astype(np.int64) - n - 1 + 2**31) % 2**32 - 2**31
    l3 = np.clip(wrap, 0, maxlen - 1)
    col = np.broadcast_to(np.arange(L)[None, :], n.shape)

    def rows(v, x):  # the table rows x of the valid columns v
        return (int(x[v].max()) - int(x[v].min()) + 1) if v.any() else 0

    rounds = []
    for b0 in range(0, B, R):
        for k in range(nc):
            at = (slice(b0, b0 + R), slice(k * S, min(L, k * S + S)))
            v, a5, a3, c = valid[at], l5[at], l3[at], col[at]
            d5 = np.where(v, np.abs(a5 - c), -1).max(1)
            d3 = np.where(v, np.abs(a3 - c), -1).max(1)
            both = rows(v, a5) + rows(v, a3)
            cls = [v & (np.where(d5 <= d3, 0, 1) == j)[:, None]
                   for j in (0, 1)]
            if both == 0:
                rounds.append(0)
            elif both <= cap:
                rounds.append(1)
            elif G == 32 and all(rows(m, a5) + rows(m, a3) <= cap
                                 for m in cls):
                rounds.append(2)
            else:
                rounds.append(0)
    return np.array(rounds)


@pytest.mark.parametrize("batch", ["1000bp_forward", "1000bp_both",
                                   "euka_calls"])
def test_staging_rounds_model_at_the_smoke_batches(batch):
    """The kernel's staging decision (staging_rounds, a model of its range
    pass) on chip_smoke.py's batches: the synthetic 1,000-bp reads stage
    every CTA in one round when all are forward, and every CTA in one or
    two rounds (some in two, none through L1) when half are reverse;
    euka's call shape (64-bp reads of both orientations) in one."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from vgan_tpu_torch import euka_ab

    tables = euka_ab.damage_tables(torch.device("cpu"))
    if batch == "euka_calls":
        args = euka_ab.euka_shape_args(tables)
    else:
        args = cs.synthetic_euka_args(tables, cs.EUKA_LONG_B, cs.EUKA_LONG_L)
        if batch == "1000bp_both":
            args = cs.both_orientations(args)
    n_pos, L_read, valid = (args[i].numpy() for i in (3, 4, 6))
    got = staging_rounds(n_pos, L_read, valid, args[7].shape[0])
    assert got.size > 0
    if batch == "1000bp_both":
        assert (got >= 1).all() and (got == 2).any()
    else:
        assert (got == 1).all()


def _c_params(fn):
    block = SRC[SRC.index('extern "C" {'):]
    m = re.search(r"int\s+" + fn + r"\s*\(([^)]*)\)\s*\{", block)
    assert m, f"{fn} not in the extern \"C\" block of csrc/euka.cu"
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("fn,argtypes", [
    ("euka_score_launch", _native.EUKA_SCORE_ARGTYPES),
    ("euka_score_config", _native.EUKA_CONFIG_ARGTYPES),
])
def test_kernel_source_exports_the_bound_symbols(fn, argtypes):
    assert _c_params(fn) == len(argtypes)
    assert re.search(r"__global__ void (__launch_bounds__\([^)]*\)\s*)?"
                     r"euka_score_kernel\(", SRC)


def test_score_batch_returns_one_2xB_tensor_on_cpu_and_split():
    arrays, tables = CASES["mixed"]
    rows = [torch.from_numpy(a) for a in arrays]
    consts = [torch.from_numpy(t) for t in tables]
    got = port_ek.score_batch(*rows, *consts)
    want = port_ek.score_batch_plain(*rows, *consts)
    assert got.shape == (2, arrays[0].shape[0]) and got.dtype == torch.float64
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    split = port_mesh.score_rows_split(
        port_ek.score_batch, rows,
        port_mesh.replicate(consts, [torch.device("cpu")] * 3))
    assert split.shape == got.shape and torch.equal(split, got)
