"""Peak rates of one NVIDIA H100 SXM, and the least time the card could
take for a batch of Smith-Waterman cells (the bound of csrc/sw.cu's
kernels), shared by the bench (`sw_bound_share`) and chip_smoke.py.

132 SMs at up to 1.98 GHz and 3.35 TB/s of HBM (NVIDIA's data sheet
and Hopper white paper). An SM issues at most 128 lane operations a
clock (four sub-partitions, one warp instruction a clock each); of
these at most 64 go to the integer ALU pipe, which alone runs compares
and min/max (DPX included), while the FMA pipe takes the rest of the
integer adds (sm_90's VIADD) and multiply-adds. A DP cell of the int32
recurrence is 9 operations: 5 on the ALU pipe (the match compare; E, F
and the running best as one VIADDMNMX each; H as one VIMNMX3 with
relu) and 4 adds (the diagonal score as an add and a predicated add,
E - 1, F - 1), as the sm_90a SASS issues them (chip_smoke.check_sass).
A hashed window column is two multiply-adds.
"""
from __future__ import annotations

SMS, CLOCK_HZ = 132, 1.98e9
ALU_LANES, SM_LANES = 64, 128  # a clock, an SM: ALU pipe, all pipes
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_CELL, FMA_OPS_PER_CELL = 5, 4
HASH_OPS_PER_COLUMN = 2


def sw_bound_ms(cells: int, hashed_columns: int, nbytes: int):
    """(least milliseconds on the card, "operations" or "bytes") for
    `cells` DP cells and `hashed_columns` hashed window columns moving
    `nbytes`: the ALU pipe's share of the operations over its 64 lanes
    an SM, or all of them over the 128 lanes an SM issues, whichever
    takes longer, against the bytes over the HBM rate."""
    alu = cells * ALU_OPS_PER_CELL
    ops = (cells * (ALU_OPS_PER_CELL + FMA_OPS_PER_CELL)
           + hashed_columns * HASH_OPS_PER_COLUMN)
    t_ops = max(alu / ALU_LANES, ops / SM_LANES) / (SMS * CLOCK_HZ)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
