# Port of vgan_tpu/parallel/mesh.py to torch: the dp and tp axes over an explicit grid of devices.
"""Data and tensor parallelism over the local cards.

The reference's only parallel structure is OpenMP threads + fork/FIFO
pipelines on one host (`src/HaploCart.cpp:313-383`). The JAX package
shards its steps over a `jax.sharding.Mesh` of local devices with a dp
(data) and a tp (path) axis; the port takes an explicit grid of devices
instead, grid[i][j] the device of dp row i and tp column j:

* HaploCart (`score_batch_split`): the mapping rows split over every
  device of the grid, row-major; on each the per-node accumulator
  c_k = segment_sum(A - b, node) and sum(b)_k are computed
  (haplocart_device.node_scores: one kernel launch on a card); the
  parts are summed on the grid's first device in device order; then
  each device of the first dp row, grid[0][j], multiplies c by tp
  column j of the node x path support matrix (the columns padded with
  zeros to a multiple of tp), and the slices come back concatenated in
  order (the callers cut them to the path count). Only those tp devices
  hold a slice of the support matrix; the others hold the small tables.
  `auto_grid` chooses tp as the JAX package's auto_mesh does: the
  smallest power of two that brings the support matrix a device under
  TP_BYTES_THRESHOLD, as far as the devices divide.
* euka (`score_rows_split`): the per-read scorer's rows split over the
  local cards as one data axis (auto_devices, the grid's devices
  flattened, as the JAX package flattens (dp, tp) for this scorer), the
  outputs concatenated in order; no reduction.
* soibean: the chain rows split over the devices when they divide
  evenly (infer/tree_mcmc.py `_run_rows`), each device running the tree
  kernel on its rows.

A grid may name one device more than once (every entry then runs on
that device in turn), so one card, or the CPU, runs the split and merge
code as a multi-card host would.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# engage tp once the replicated support matrix would exceed this many
# bytes a device: the JAX package's threshold (vgan_tpu/parallel/
# mesh.py:52), kept so that a host of n devices makes the same choice.
# It was sized for a TPU chip's memory; the real DB's 490 MB (11,825 x
# 5,179 f64) fits an 80 GB card many times over, so on cards tp only
# saves memory (support / tp on each of the tp devices), at the cost of
# one copy of c a tp column and of the slices' gather (PERF.md).
TP_BYTES_THRESHOLD = 128 * 1024 * 1024


def auto_devices(device, limit: Optional[int] = None
                 ) -> Optional[List[torch.device]]:
    """Every visible card, at most `limit` of them (`--devices N`; 0 or
    1 turns the split off), when `device` is a card and that leaves
    more than one; else None (the single-device paths run)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    n = torch.cuda.device_count()
    if limit is not None:
        n = min(n, limit)
    if n <= 1:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def make_grid(devices: Sequence[torch.device], support_bytes: int = 0
              ) -> List[List[torch.device]]:
    """The n devices as a [dp][tp] grid, row-major as the JAX package's
    make_mesh lays them out, by its auto_mesh rule: tp starts at 1 and
    doubles while tp < n, n % (2 tp) == 0 and support_bytes // tp
    exceeds TP_BYTES_THRESHOLD; dp = n // tp."""
    n, tp = len(devices), 1
    while tp < n and n % (tp * 2) == 0 and (
            support_bytes // tp > TP_BYTES_THRESHOLD):
        tp *= 2
    return [list(devices[i * tp:(i + 1) * tp]) for i in range(n // tp)]


def auto_grid(device, limit: Optional[int] = None, support_bytes: int = 0
              ) -> Optional[List[List[torch.device]]]:
    """auto_devices as a [dp][tp] grid for a support matrix of
    `support_bytes` (HaploCart's node x path f64 matrix); None where
    auto_devices is None (the single-device paths run)."""
    devs = auto_devices(device, limit)
    return None if devs is None else make_grid(devs, support_bytes)


def split_rows(n: int, parts: int) -> List[slice]:
    """`parts` contiguous row slices of n rows, ceil-sized in order, the
    last ones short or empty."""
    per = -(-n // parts) if parts else 0
    return [slice(min(i * per, n), min((i + 1) * per, n))
            for i in range(parts)]


def replicate(tensors: Sequence[torch.Tensor],
              devices: Sequence[torch.device]) -> List[List[torch.Tensor]]:
    """The tensors copied onto each device (no copy where they already
    sit there)."""
    return [[t.to(d) for t in tensors] for d in devices]


def shard_tables(base, grid, cache: Optional[dict] = None):
    """HcTables `base` (on any device) laid out over a [dp][tp] grid of
    devices, in its shape: grid[0][j] gets the small tables and tp
    column j of the support matrix in f64, its columns padded with zeros
    to a multiple of tp (the JAX package's shard_tables); every other
    device scores rows only, and gets the tables that device already
    holds, else the small tables with a support matrix of no columns
    (its node count only).
    `cache` maps (device, tp, column) to tables built before, column None
    for those of no columns."""
    from ..pipelines.haplocart_device import HcTables

    tp = len(grid[0])
    cache = {} if cache is None else cache
    sup = base.support

    def small(d, support):
        return HcTables(**{
            f.name: getattr(base, f.name).to(d) for f in fields(HcTables)
            if f.name != "support"}, support=support)

    def shard(d, j):
        key = (str(d), tp, j)
        if key not in cache:
            w = -(-sup.shape[1] // tp)
            cols = sup[:, j * w:(j + 1) * w].to(d, torch.float64)
            cache[key] = small(d, F.pad(cols, (0, w - cols.shape[1]))
                               .contiguous())
        return cache[key]

    def rows_only(d):
        t = next((t for k, t in cache.items() if k[0] == str(d)), None)
        if t is None:
            t = cache[(str(d), tp, None)] = small(d, torch.empty(
                (sup.shape[0], 0), dtype=torch.float64, device=d))
        return t

    first = [shard(d, j) for j, d in enumerate(grid[0])]
    return [first] + [[rows_only(d) for d in row] for row in grid[1:]]


def hc_tables(db, grid):
    """The DB's HaploCart scorer tables over a [dp][tp] grid of devices,
    as shard_tables lays them out, built once a (device, tp, column) and
    cached on the DB. The support matrix is cut from the DB's host array:
    no card holds the whole of it for the split (with tp > 1)."""
    from ..pipelines.haplocart_device import make_tables_from_db

    cache = getattr(db, "_mesh_tables", None)
    if cache is None:
        cache = db._mesh_tables = {}
    # the DB's bool matrix as it lies on the host (no copy); each shard is
    # cut from it and made f64 on its device
    sup = torch.from_numpy(np.ascontiguousarray(db.graph.path_support))
    return shard_tables(make_tables_from_db(db, "cpu", support=sup), grid,
                        cache)


def score_batch_split(batch, tables, bep=1e-4,
                      consensus: bool = False) -> torch.Tensor:
    """final_vec of one HcBatch (on any device) over a [dp][tp] grid of
    HcTables (hc_tables): the rows split over every device of the grid,
    row-major, each part scored to c_k and sum(b)_k there; the parts
    summed on the first device in device order; then sum(b) + c @
    support_j on grid[0][j], the device of tp column j, the slices
    concatenated in order on the first device (the JAX package's
    sharded_score_fn, its psum over dp in device order). With tp > 1 the
    result has the padded path count: the caller cuts it to the DB's
    paths, as the JAX package's callers do."""
    from ..pipelines.haplocart_device import HcBatch, node_scores

    flat = [t for row in tables for t in row]
    parts = []
    # every device's work is queued before any part is read back
    for rows, t in zip(split_rows(batch.g.shape[0], len(flat)), flat):
        dev = t.support.device
        sub = HcBatch(**{f.name: getattr(batch, f.name)[rows].to(dev)
                         for f in fields(HcBatch)})
        parts.append(node_scores(sub, t, bep, consensus))
    dev0 = flat[0].support.device
    c, total_b = parts[0]
    for ck, bk in parts[1:]:
        c = c + ck.to(dev0)
        total_b = total_b + bk.to(dev0)
    outs = []
    for t in tables[0]:
        d = t.support.device
        outs.append((total_b.to(d) + c.to(d) @ t.support).to(dev0))
    return torch.cat(outs)


def score_rows_split(fn: Callable, rows: Sequence[torch.Tensor],
                     consts: Sequence[Sequence[torch.Tensor]]):
    """fn(*row_tensors, *consts[k]) on device k for its contiguous share
    of the rows (consts[k]: that device's copies of the tables, e.g.
    from `replicate`); fn returns one [k, rows] tensor, and the shares
    come back as one [k, all rows] tensor on the first device."""
    devs = [c[0].device for c in consts]
    outs = []
    for sl, dev, cs in zip(split_rows(rows[0].shape[0], len(devs)), devs,
                           consts):
        outs.append(fn(*[r[sl].to(dev) for r in rows], *cs))
    return torch.cat([o.to(devs[0]) for o in outs], dim=1)
