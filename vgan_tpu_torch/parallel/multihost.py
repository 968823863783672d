# Port of vgan_tpu/parallel/multihost.py to torch.distributed (host logic copied; the global mesh and its psum become one gloo all-reduce).
"""Multi-process execution.

The reference's only cross-process structure is the fork+FIFO chain on
one machine (`src/HaploCart.cpp:313-383`). Here each host (or each card)
runs one process; `init_distributed` joins them into one
`torch.distributed` process group, reads shard across processes by
rank, every process maps and scores its own shard on its own device,
and the per-pipeline results merge through collectives. Host 0
performs all file output.

Activation: `python -m vgan_tpu_torch.cli <cmd> ... --coordinator
host:port --nproc N --procid I`, or the VGAN_COORDINATOR / VGAN_NPROC /
VGAN_PROCID environment variables (set by the launcher on every host).

Why gloo for every collective. What crosses processes is small: pickled
host objects (euka's per-clade accumulators, soibean's chain summaries,
keelime's fragments) and HaploCart's per-node accumulator, one f64
vector of n_nodes (<= 11,825 x 8 B = 95 KB at the real DB) plus its
penalty sum. gloo carries both from host memory, and it lets two ranks
share one card, which NCCL refuses: that is how the tests and the smoke
run. So the accumulator is reduced as an explicit CPU copy and the sum
is put back on the rank's device; the scoring itself, and the one GEMV
after the reduction, stay on the rank's device. This is a design, not
a fallback: no path here would use NCCL.

`torch.distributed` is imported only inside functions, so importing
this module picks no device and starts nothing.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# a collective that one rank never reaches fails after this long
# instead of hanging (ranks of one job wait for each other at a
# collective, so it must outlast the longest stage between two of them)
TIMEOUT_S = 1800


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Join the process group (gloo over TCP at `coordinator`,
    host:port, which rank 0 listens on). Returns True if distributed
    mode is active. Arguments default to the VGAN_* environment
    variables; a missing coordinator means single-process mode."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("VGAN_COORDINATOR")
    if not coordinator:
        return False
    if dist.is_initialized():
        return True
    num_processes = num_processes or int(os.environ.get("VGAN_NPROC", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("VGAN_PROCID", "0"))
    )
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"--procid {process_id} outside 0..{num_processes - 1}"
        )
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def shutdown() -> None:
    """Leave the process group (a no-op in single-process mode)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def active() -> bool:
    """True when running as part of a multi-process job."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_id() -> int:
    import torch.distributed as dist

    return dist.get_rank() if active() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if active() else 1


def is_host0() -> bool:
    return process_id() == 0


def shard_bounds(n: int, pid: int, nproc: int) -> Tuple[int, int]:
    """[lo, hi) of rank `pid`'s contiguous slice of n items: ceil-sized
    slices in rank order, the last ones short or empty."""
    per = -(-n // nproc)
    return min(pid * per, n), min((pid + 1) * per, n)


def shard_reads(reads: Sequence) -> List:
    """This process's contiguous slice of the read list (by rank)."""
    n = process_count()
    if n == 1:
        return list(reads)
    lo, hi = shard_bounds(len(reads), process_id(), n)
    return list(reads[lo:hi])


def allgather_objects(obj):
    """Gather one picklable object per process; every process receives
    the rank-ordered list (`dist.all_gather_object` over gloo). The
    primitive the per-pipeline merges build on."""
    import torch.distributed as dist

    if not active() or process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def merge_euka_results(res, min_frag: int, min_bins: int, max_bins: int,
                       entropy_threshold: float):
    """Merge per-process EukaResults into the global one: counters,
    bin coverage and baseshift profiles SUM across ranks; the per-read
    lists (clade likelihoods, insert sizes, fragment names) concatenate
    in rank order (= global read order, shard_reads slices
    contiguously); detection re-runs on the merged accumulators
    (euka.detect_clades — the `src/Euka.cpp:625-633` filter must see
    global coverage). Every process returns the same merged result;
    host 0 does the writing."""
    from ..pipelines.euka import EukaResult, detect_clades

    parts = allgather_objects(
        dict(
            counts=res.counts, n_mapped=res.n_mapped,
            baseshift=res.baseshift, coverage=res.coverage,
            clade_like=res.clade_like, insert_sizes=res.insert_sizes,
            frag_names=res.frag_names,
        )
    )
    if len(parts) == 1:
        return res
    nC = len(res.clades)
    counts = np.sum([p["counts"] for p in parts], axis=0)
    n_mapped = np.sum([p["n_mapped"] for p in parts], axis=0)
    baseshift = np.sum([p["baseshift"] for p in parts], axis=0)
    coverage = [
        [
            float(sum(p["coverage"][i][j] for p in parts))
            for j in range(len(res.chunks[i]))
        ]
        for i in range(nC)
    ]
    clade_like = [
        [x for p in parts for x in p["clade_like"][i]] for i in range(nC)
    ]
    insert_sizes = [
        [x for p in parts for x in p["insert_sizes"][i]] for i in range(nC)
    ]
    frag_names = [
        [x for p in parts for x in p["frag_names"][i]] for i in range(nC)
    ]
    detected = detect_clades(
        res.chunks, coverage, counts, min_frag, min_bins, max_bins,
        entropy_threshold,
    )
    return EukaResult(
        clades=res.clades, chunks=res.chunks, coverage=coverage,
        counts=counts, n_mapped=n_mapped, clade_like=clade_like,
        insert_sizes=insert_sizes, frag_names=frag_names,
        baseshift=baseshift, detected=detected,
    )


def score_alignments_multihost(db, local_alignments, bep: float = 1e-4,
                               is_consensus_fasta: bool = False):
    """HaploCart scorer with the mapping axis sharded across ALL
    processes: each rank builds the batch of its own alignments and
    computes, on db.device, c = segment_sum(A - b, node) and sum(b)
    (haplocart_device.node_scores, A = mapping_scores); c and sum(b)
    are summed over the ranks (one gloo all-reduce of an n_nodes + 1
    f64 CPU vector); then each rank forms
    final_vec = sum(b) + c @ support, one GEMV on its device
    (`src/HaploCart.cpp:408-421` over the cluster). A rank may hold
    zero mapped reads: it contributes zeros. Every rank returns the
    same final_vec (numpy f64)."""
    import torch
    import torch.distributed as dist

    from ..pipelines.haplocart_device import (
        batch_from_alignments,
        device_tables,
        node_scores,
    )
    from ..utils import guards

    tables = device_tables(db)
    dev = tables.support.device
    n_nodes = tables.support.shape[0]
    batch = batch_from_alignments(db, local_alignments, dev, bucket_m=False)
    part = torch.zeros(n_nodes + 1, dtype=torch.float64, device=dev)
    if batch is not None:
        if is_consensus_fasta:
            batch.use_bep = torch.ones_like(batch.use_bep)
        c, total_b = node_scores(batch, tables, bep, is_consensus_fasta)
        part[:n_nodes] = c
        part[n_nodes] = total_b
    if active() and process_count() > 1:
        host = part.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        part = host.to(dev)
    out = part[n_nodes] + part[:n_nodes] @ tables.support
    out = out.cpu().numpy().astype(np.float64)
    guards.check_finite(out, "haplocart final_vec (multi-process)")
    return out
