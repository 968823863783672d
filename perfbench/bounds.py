# Frozen from chip_smoke.py (tree_bound_ms, F64_FMA_PER_S), vgan_tpu_torch/utils/roofline.py (the H100's peaks) and vgan_tpu_torch/infer/tree_mcmc.py (burn_walk_hops, POST_BURN_HOPS).
"""Peaks of one NVIDIA H100 SXM and the least time the card could take
for the tree MCMC's steps, computed from a batch's shapes alone.

NVIDIA's data sheet: 3.35 TB/s of HBM; 67 TFLOP/s of float64 in the
tensor cores, the largest f64 rate the card has (so 33.5 T multiply-adds
a second).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F64_FMA_PER_S = 67e12 / 2
POST_BURN_HOPS = 8
WALK_HOPS = 32


def burn_walk_hops(num_paths: int) -> int:
    """Hops of the burn-in walk: 4 x the annealing's start sd + 8,
    between POST_BURN_HOPS and WALK_HOPS (the start sd is 3, or
    num_paths / 10 above 30 paths)."""
    init_sd = 3.0 if num_paths <= 30 else num_paths * (3.0 / 30.0)
    return int(min(WALK_HOPS, max(POST_BURN_HOPS, 4 * init_sd + 8)))


def tree_bound_s(rows: int, kmax: int, active: int, steps: int, reads: int,
                 paths: int, count_bytes: int, hops: int) -> float:
    """Least seconds for `steps` steps of a batch of `rows` chain rows
    (`active` of their rows x kmax source slots in use) over `reads`
    reads and `paths` paths: every input read once and every output
    written once (the path-major tables [P, R] f64 and [P, R, 25] of
    `count_bytes` each, the f32 noise and the trace), against the f64
    multiply-adds of the counts' dot products (25 a read and source
    slice, two slices an active source) at the card's f64 rate,
    whichever takes longer."""
    nbytes = (paths * reads * 8 + paths * reads * 25 * count_bytes
              + steps * rows * (kmax * (2 + 4 * hops) + 1) * 4
              + steps * rows * (kmax * 20 + 8))
    fma = steps * active * 2 * reads * 25
    return max(nbytes / HBM_BYTES_PER_S, fma / F64_FMA_PER_S)
