"""keelime's overlap scans read by index from one sequence table
(vgan_tpu_torch/pipelines/keelime_device.py: overlap_best_indexed, its
length-class split and its plain versions), on the CPU, against the JAX
package's device batch (keelime_device.overlap_scores_batch) and per-pair
scorer (keelime.overlap_score), exactly: every score is a multiple of
0.5, summed exactly by all of them.

* overlap_best_indexed (the native scan on the pairs gathered from the
  table) equals overlap_best_batch, the plain overlap_scores_batch, the
  plain version on the code table (plain_indexed) and JAX, on edge-case
  and random pairs, 16,569-bp pairs, repeated contents, self-pairs,
  empty b's, a's shorter than min_olen and an empty index list.
* L_WARP is the warp kernel's kLWarp in csrc/keelime.cu.
* scan_by_class, with the plain versions in place of the two kernels
  (plain_warp_scan, plain_block_scan), gives every pair to exactly one
  class, by a's length against L_WARP, and writes each result back at
  its pair's index.
"""
import os
import re

import numpy as np
import pytest
import torch

import _torch_world as world
from vgan_tpu.pipelines import keelime as jax_kl
from vgan_tpu.pipelines import keelime_device as jax_kd
from vgan_tpu_torch.pipelines import keelime as port_kl
from vgan_tpu_torch.pipelines import keelime_device as port_kd

torch.set_num_threads(1)


def _table(pairs):
    """(seq_buf, seq_off, ai, bi) CPU tensors: the pairs' strings
    interned once, in first-seen order."""
    ids = {}
    ai = np.array([ids.setdefault(a, len(ids)) for a, _ in pairs], np.int32)
    bi = np.array([ids.setdefault(b, len(ids)) for _, b in pairs], np.int32)
    buf, off = port_kd.intern(list(ids))
    return tuple(torch.from_numpy(x) for x in (buf, off, ai, bi))


def _as_list(ln, sc):
    return list(zip(ln.tolist(), sc.tolist()))


def _random_pairs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    alpha = np.array(list(world.KEELIME_ALPHABET + "xZ"))
    pairs = []
    for i in range(n):
        a = "".join(rng.choice(alpha, int(rng.integers(lo, hi))))
        b = "".join(rng.choice(alpha, int(rng.integers(lo, hi))))
        if i % 4 == 0:  # a planted overlap: a's suffix is b's prefix
            b = a[int(rng.integers(0, len(a) + 1)):] + b
        pairs.append((a, b))
    return pairs


def _case(name):
    """(pairs, min_olen, min_score, JAX's device batch usable)."""
    if name == "traps":
        return world.overlap_trap_pairs(), 3, 21.5, True
    if name == "adversarial":
        return world.overlap_adversarial_pairs(), 3, 5.0, True
    if name == "mitogenome":
        rng = np.random.default_rng(5)
        seq = "".join(rng.choice(np.array(list("ACGT")), 16569))
        return ([(seq, seq), (seq[:16400], seq[120:]),
                 (seq, seq[::-1][:4000]), (seq[:5000], seq)], 40, 60.0,
                False)
    if name == "repeated":
        # 12 contents in 300 pairs, as find_overlaps' reads repeat
        base = _random_pairs(7, 6, 40, 70)
        contents = [s for p in base for s in p]
        rng = np.random.default_rng(8)
        return ([(contents[i], contents[j])
                 for i, j in rng.integers(0, len(contents), (300, 2))],
                10, 10.0, True)
    if name == "self":
        pairs = _random_pairs(9, 20, 1, 80)
        return [(a, a) for a, _ in pairs], 5, 10.0, True
    if name == "empty_b":
        return [("ACGTACGT" * 4, ""), ("ACGT", ""), ("", "")], 1, 0.0, True
    if name == "short_a":
        return ([("ACG", "ACGTACGT"), ("ACGTACG", "ACGTACG"),
                 ("ACGTACGTAC", "ACGTACGTAC")], 8, 1.0, True)
    if name == "random":
        return _random_pairs(21, 400, 0, 130), 10, 10.0, True
    raise ValueError(name)


@pytest.mark.parametrize("case", ["traps", "adversarial", "mitogenome",
                                  "repeated", "self", "empty_b", "short_a",
                                  "random"])
def test_overlap_best_indexed_equal_to_jax(case):
    pairs, min_olen, min_score, jax_batch = _case(case)
    want = [jax_kl.overlap_score(a, b, min_olen, min_score)
            for a, b in pairs]
    if jax_batch:
        assert jax_kd.overlap_scores_batch(pairs, min_olen, min_score,
                                           chunk=64) == want
        assert port_kd.overlap_scores_batch(pairs, min_olen, min_score,
                                            chunk=64) == want
    buf, off, ai, bi = _table(pairs)
    if case == "self":
        assert torch.equal(ai, bi)
    got = port_kd.overlap_best_indexed(buf, off, ai, bi, min_olen, min_score)
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.float64
    assert _as_list(*got) == want
    assert port_kd.overlap_best_batch(pairs, min_olen, min_score,
                                      "cpu") == want
    codes = port_kd.seq_codes(buf)
    assert _as_list(*port_kd.plain_indexed(codes, off, ai, bi, min_olen,
                                           min_score)) == want


def test_overlap_best_indexed_empty_index_list():
    buf, off, _, _ = _table([("ACGT", "CGTA")])
    none = torch.zeros(0, dtype=torch.int32)
    ln, sc = port_kd.overlap_best_indexed(buf, off, none, none, 1, 0.0)
    assert ln.shape == (0,) and ln.dtype == torch.int64
    assert sc.shape == (0,) and sc.dtype == torch.float64
    assert port_kd.overlap_best_batch([], 1, 0.0, "cpu") == []


def test_overlap_best_indexed_refuses_mixed_inputs():
    buf, off, ai, bi = _table([("ACGT", "CGTA")])
    with pytest.raises(ValueError):
        port_kd.overlap_best_indexed(buf, off, ai.long(), bi, 1, 0.0)
    with pytest.raises(ValueError):
        port_kd.overlap_best_indexed(buf.long(), off, ai, bi, 1, 0.0)


def test_seq_codes_is_the_lut():
    buf, _, _, _ = _table([("ACGTRYNS-acgtry", "xZ#\x00\xff")])
    lut, _ = port_kd.code_tables()
    assert np.array_equal(port_kd.seq_codes(buf).numpy(), lut[buf.numpy()])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_by_class_split_and_scatter(seed):
    """Pairs with la at L_WARP - 1, L_WARP and L_WARP + 1 (and short
    ones), shuffled: the short class is exactly la <= L_WARP, every pair
    is scanned once, and the results land at their own indices, equal to
    the native scan and JAX."""
    L = port_kd.L_WARP
    rng = np.random.default_rng(seed)
    alpha = np.array(list("ACGTRY"))
    core = "".join(rng.choice(alpha, L + 1))
    pairs = []
    for la in (L - 1, L, L + 1, 64, 3):
        a = core[:la]
        for lb in (la, 40, L + 7):
            k = int(rng.integers(0, la))
            b = (a[k:] + core)[:lb]
            pairs.append((a, b))
    pairs = [pairs[i] for i in rng.permutation(len(pairs))]
    buf, off, ai, bi = _table(pairs)
    la = np.array([len(a) for a, _ in pairs])
    seen = {}

    def recording(name, plain):
        def scan(seq_buf, seq_off, ai, bi, order, n_short, *rest):
            ks = (order[: int(n_short)] if name == "short"
                  else order[int(n_short):]).tolist()
            seen[name] = ks
            plain(seq_buf, seq_off, ai, bi, order, n_short, *rest)
        return scan

    got = port_kd.scan_by_class(
        buf, off, ai, bi, 10, 10.0,
        scans=(recording("short", port_kd.plain_warp_scan),
               recording("long", port_kd.plain_block_scan)))
    assert sorted(seen["short"] + seen["long"]) == list(range(len(pairs)))
    assert seen["short"] == sorted(np.flatnonzero(la <= L).tolist())
    assert seen["long"] == sorted(np.flatnonzero(la > L).tolist())
    want = [jax_kl.overlap_score(a, b, 10, 10.0) for a, b in pairs]
    assert _as_list(*got) == want
    assert _as_list(*port_kd.overlap_best_indexed(buf, off, ai, bi, 10,
                                                  10.0)) == want


@pytest.mark.parametrize("longest,scanned", [
    (None, ["short", "long"]), (port_kd.L_WARP + 1, ["short", "long"]),
    (port_kd.L_WARP, ["short"]), (64, ["short"])])
def test_scan_by_class_skips_long_class(longest, scanned):
    """A `longest` of at most L_WARP (no pair can be long) runs the short
    class's scan alone; otherwise both run."""
    pairs = [("ACGTACGTAC" * 6, "GTACGTAC" * 5), ("ACGT" * 3, "CGTA")]
    buf, off, ai, bi = _table(pairs)
    ran = []

    def named(name, plain):
        def scan(*args):
            ran.append(name)
            plain(*args)
        return scan

    got = port_kd.scan_by_class(
        buf, off, ai, bi, 3, 5.0, longest,
        scans=(named("short", port_kd.plain_warp_scan),
               named("long", port_kd.plain_block_scan)))
    assert ran == scanned
    assert _as_list(*got) == [jax_kl.overlap_score(a, b, 3, 5.0)
                              for a, b in pairs]


@pytest.mark.parametrize("strings,want", [
    ([], 0), (["", "A"], 1), (["ACGT", "A" * 300, "AC"], 300)])
def test_longest_of(strings, want):
    assert port_kd.longest_of(port_kd.intern(strings)[1]) == want


def test_l_warp_is_the_kernels():
    src = open(os.path.join(os.path.dirname(port_kd.__file__), os.pardir,
                            "csrc", "keelime.cu")).read()
    m = re.search(r"constexpr int kLWarp = (\d+);", src)
    assert m and int(m.group(1)) == port_kd.L_WARP


def test_split_by_length_order():
    L = port_kd.L_WARP
    la = torch.tensor([5, L + 44, 7, L + 44, L, L + 1, 1], dtype=torch.int64)
    order, n_short = port_kd.split_by_length(la)
    assert order.dtype == torch.int32 and n_short.dtype == torch.int32
    assert int(n_short) == 4
    assert order.tolist() == [0, 2, 4, 6, 1, 3, 5]


def test_find_overlaps_indices_match_pair_list():
    """find_overlaps' index arrays (keys // C, keys % C over the interned
    contents) score the same pairs as the string pair list it replaced."""
    rng = np.random.default_rng(4)
    contents = ["".join(rng.choice(np.array(list("ACGTRY")), 64))
                for _ in range(30)]
    C = len(contents)
    keys = np.unique(rng.integers(0, C * C, 200))
    pairs = [(contents[k // C], contents[k % C]) for k in keys]
    buf, off = (torch.from_numpy(x) for x in port_kd.intern(contents))
    got = port_kd.overlap_best_indexed(
        buf, off, torch.from_numpy((keys // C).astype(np.int32)),
        torch.from_numpy((keys % C).astype(np.int32)), 10, 10.0)
    assert _as_list(*got) == [port_kl.overlap_score(a, b, 10, 10.0)
                              for a, b in pairs]
