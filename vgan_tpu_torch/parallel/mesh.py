# Port of vgan_tpu/parallel/mesh.py to torch: the dp axis over an explicit list of devices; the tp axis is not ported.
"""Data parallelism over the local cards.

The reference's only parallel structure is OpenMP threads + fork/FIFO
pipelines on one host (`src/HaploCart.cpp:313-383`). The JAX package
shards its steps over a `jax.sharding.Mesh` of local devices; the port
takes an explicit list of devices instead:

* HaploCart (`score_batch_split`): the mapping rows split over the
  devices, the scorer tables replicated on each; per device, the
  per-node accumulator c_k = segment_sum(A - b, node) and sum(b)_k are
  computed there (haplocart_device.node_scores: one kernel launch on a
  card); the parts are summed on the first device in device
  order, then one GEMV with the support matrix there.
* euka (`score_rows_split`): the per-read scorer's rows split, the
  outputs concatenated in order; no reduction.
* soibean: the chain rows split over the devices when they divide
  evenly (infer/tree_mcmc.py `_run_rows`), each device running the tree
  kernel on its rows.

A list may name one device more than once (every entry then runs on
that device in turn), so one card, or the CPU, runs the split and merge
code as a multi-card host would.

Not ported: the JAX package's tp axis (`vgan_tpu/parallel/mesh.py:
48-90`), which splits the support matrix over paths once it passes
128 MB a chip. That threshold was sized for a TPU's HBM; the real
support matrix (11,825 x 5,179 f64, ~490 MB) fits an 80 GB card many
times over, so every device holds all of it.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Callable, List, Optional, Sequence

import torch


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


def hc_tables(db, devices: Sequence[torch.device]):
    """The DB's HaploCart scorer tables on each device, built once a
    device and cached on the DB."""
    from ..pipelines.haplocart_device import HcTables, device_tables

    base = device_tables(db)
    cache = getattr(db, "_mesh_tables", None)
    if cache is None:
        cache = db._mesh_tables = {str(base.support.device): base}
    out = []
    for d in devices:
        t = cache.get(str(d))
        if t is None:
            t = cache[str(d)] = HcTables(**{
                f.name: getattr(base, f.name).to(d) for f in fields(HcTables)
            })
        out.append(t)
    return out


def score_batch_split(batch, tables: Sequence, bep=1e-4,
                      consensus: bool = False) -> torch.Tensor:
    """final_vec of one HcBatch (on any device) with its rows split over
    the devices of `tables` (one HcTables a device): each device scores
    its rows to c_k and sum(b)_k, the parts are summed on the first
    device in device order, and one GEMV there gives
    sum(b) + c @ support (the JAX package's sharded_score_fn with tp = 1,
    its psum in device order)."""
    from ..pipelines.haplocart_device import HcBatch, node_scores

    parts = []
    # every device's work is queued before any part is read back
    for rows, t in zip(split_rows(batch.g.shape[0], len(tables)), tables):
        dev = t.support.device
        sub = HcBatch(**{f.name: getattr(batch, f.name)[rows].to(dev)
                         for f in fields(HcBatch)})
        parts.append(node_scores(sub, t, bep, consensus))
    dev0 = tables[0].support.device
    c, total_b = parts[0]
    for ck, bk in parts[1:]:
        c = c + ck.to(dev0)
        total_b = total_b + bk.to(dev0)
    return total_b + c @ tables[0].support


def score_rows_split(fn: Callable, rows: Sequence[torch.Tensor],
                     consts: Sequence[Sequence[torch.Tensor]]):
    """fn(*row_tensors, *consts[k]) on device k for its contiguous share
    of the rows (consts[k]: that device's copies of the tables, e.g.
    from `replicate`); fn returns a tuple of [rows, ...] tensors, which
    come back concatenated in row order on the first device."""
    devs = [c[0].device for c in consts]
    outs = []
    for sl, dev, cs in zip(split_rows(rows[0].shape[0], len(devs)), devs,
                           consts):
        outs.append(fn(*[r[sl].to(dev) for r in rows], *cs))
    return tuple(torch.cat([o[i].to(devs[0]) for o in outs])
                 for i in range(len(outs[0])))
