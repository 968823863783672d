# Port of vgan_tpu/pipelines/haplocart_device.py to torch (f64 on CPU and GPU).
"""Device-resident HaploCart scoring step.

The full per-batch compute of `src/HaploCart.cpp:408-421`: per-base
probability math on [M, S] mapping tiles and per-node
scatter-accumulation (the JAX code's segment_sum) in one function,
`node_scores` (on the card one launch of hc_node_scores_kernel,
csrc/haplocart.cu; on the CPU its plain version, `mapping_scores` +
`index_add_`), then the path reduction as a single [n_nodes] x
[n_nodes, n_paths] matrix-vector product. M = total mappings in the
batch, S = max node length (8 for the HC graph, `src/test.cpp:627`).

Everything runs in float64 on the CPU and on the card alike (the H100
has native f64; the JAX package's f32-on-TPU rule, `_default_dtype`,
was a TPU compiler workaround and is not carried over). The functions
take tensors that already sit on a device, or a `device` argument.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..models import mutation, phred

F64 = torch.float64


@dataclass
class HcBatch:
    """Columnar mapping batch (padded)."""

    g: torch.Tensor  # [M, S] graph codes (0..3 ACGT, >=4 skip)
    r: torch.Tensor  # [M, S] read codes (from read start — reference quirk)
    q: torch.Tensor  # [M, S] int quality of the mapping slice
    pang: torch.Tensor  # [M] pangenome coordinate of the mapping's node
    mq: torch.Tensor  # [M] read mapping quality
    b: torch.Tensor  # [M] unsupported-path penalty (precomputed log-sum)
    node: torch.Tensor  # [M] node index
    valid: torch.Tensor  # [M, S] in-bounds mask
    use_bep: torch.Tensor  # [M] read's sticky qual>=90 flag
    #   (`src/update_likelihood.cpp:42`: eps from the background error
    #   prob instead of the quality string; always set in consensus
    #   mode, `src/HaploCart.cpp:394-399`)


@dataclass
class HcTables:
    match_tab: torch.Tensor  # [PAN] (1-mu)^gens
    mapp_tab: torch.Tensor  # [PAN] mappability
    qtab: torch.Tensor  # [100] p_seq_error
    imtab: torch.Tensor  # [100] p_incorrectly_mapped
    bg: torch.Tensor  # [8] background freqs by code
    support: torch.Tensor  # [n_nodes, n_paths]


def _bg() -> np.ndarray:
    return np.concatenate([mutation.BACKGROUND_FREQ, [0.25, 0.25, 0.25]])


def make_tables(support: np.ndarray, device, dtype=F64) -> HcTables:
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return HcTables(
        match_tab=t(mutation.match_prob_table()),
        mapp_tab=t(np.ones(mutation.PANGENOME_LEN)),
        qtab=t(phred.qscore_vec()),
        imtab=t(phred.incorrect_mapping_vec()),
        bg=t(_bg()),
        support=t(support),
    )


def make_tables_from_db(db, device, dtype=F64) -> HcTables:
    mapp = db.mappabilities
    need = int(db.pangenome_base.max()) + 1
    if len(mapp) < need:
        mapp = np.concatenate([mapp, np.ones(need - len(mapp))])

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return HcTables(
        match_tab=t(db.match_prob),
        mapp_tab=t(mapp),
        qtab=t(phred.qscore_vec()),
        imtab=t(phred.incorrect_mapping_vec()),
        bg=t(_bg()),
        support=t(db.graph.path_support),
    )


def tables_from_numpy(d: dict, device) -> HcTables:
    """HcTables from the JAX package's HcTables fields given as numpy
    arrays (name -> array), placed on `device` with their dtypes."""
    return HcTables(**{
        k: torch.tensor(np.asarray(d[k]), device=device)
        for k in ("match_tab", "mapp_tab", "qtab", "imtab", "bg", "support")
    })


def _table_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Index i into a table of n entries as JAX's gather takes it: a
    negative index counts from the end, then the index clamps to the
    table."""
    i = i.long()
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def mapping_scores(batch: HcBatch, t: HcTables, bep, consensus: bool):
    """Per-mapping supported-increment A[M] (`src/process_mapping.cpp:54-81`)."""
    qv = t.qtab[batch.q.clamp(0, 99).long()]
    valid = batch.valid & (batch.g < 4) & (batch.r < 4)
    match = batch.g == batch.r
    eps_q = torch.where(match, qv, 1.0 - qv)
    # qual>=90 / consensus reads: eps from the background error prob
    # (`src/get_p_obs_base.cpp:14-17`)
    bep_t = torch.as_tensor(bep, dtype=qv.dtype, device=qv.device)
    eps_b = torch.where(match, bep_t, 1.0 - bep_t)
    eps = torch.where(batch.use_bep[:, None], eps_b, eps_q)
    # pang and r index their tables as the JAX gathers do (_table_index)
    match_p = t.match_tab[_table_index(batch.pang, t.match_tab.shape[0])]
    p_obs = match_p[:, None] * (1.0 - eps)
    if consensus:
        term = torch.log((1.0 - bep_t) * p_obs)
    else:
        p_correct = (
            1.0 - t.imtab[batch.mq.clamp(0, 99).long()]
        ) * t.mapp_tab[_table_index(batch.pang, t.mapp_tab.shape[0])]
        # codes past the table (255 padding) read its last entry; those
        # positions are masked below
        bg = t.bg[_table_index(batch.r, t.bg.shape[0])]
        term = torch.log(
            (1.0 - p_correct)[:, None] * bg + p_correct[:, None] * p_obs
        )
    zero = torch.zeros((), dtype=term.dtype, device=term.device)
    return torch.where(valid, term, zero).sum(dim=1)


@dataclass
class HcPacked:
    """hc_columnar.pack_batch's single uint8 buffer as views into it (no
    copy): the columns as the buffer holds them."""

    g: torch.Tensor  # [M, S] uint8
    r: torch.Tensor  # [M, S] uint8
    q: torch.Tensor  # [M, S] uint8
    mq: torch.Tensor  # [M] uint8
    use_bep: torch.Tensor  # [M] uint8 (> 0: set)
    pang: torch.Tensor  # [M] int32
    node: torch.Tensor  # [M] int32
    take: torch.Tensor  # [M] int32: positions s < take are valid
    b: torch.Tensor  # [M] f64


def unpack(buf: torch.Tensor, M: int, S: int, dtype=F64) -> HcPacked:
    """Views of pack_batch's buffer (the JAX package's byte layout, so
    both sides can be fed the same buffer): [3*M*S] g|r|q, [2*M]
    mq|use_bep, pad to 8, [12*M] pang|node|take int32, [M] b as dtype."""
    grq = buf[: 3 * M * S].view(3, M, S)
    o = 3 * M * S
    mq, use_bep = buf[o : o + M], buf[o + M : o + 2 * M]
    o += 2 * M
    o += (-o) % 8
    i32 = buf[o : o + 12 * M].view(torch.int32)
    o += 12 * M
    isz = torch.empty((), dtype=dtype).element_size()
    return HcPacked(g=grq[0], r=grq[1], q=grq[2], mq=mq, use_bep=use_bep,
                    pang=i32[:M], node=i32[M : 2 * M], take=i32[2 * M :],
                    b=buf[o : o + isz * M].view(dtype))


def packed_batch(p: HcPacked, consensus: bool) -> HcBatch:
    """The HcBatch that the packed views stand for (consensus sets every
    row's use_bep, as the packed path always has)."""
    S = p.g.shape[1]
    valid = (torch.arange(S, dtype=torch.int32, device=p.g.device)[None, :]
             < p.take[:, None])
    use_bep = p.use_bep > 0
    if consensus:
        use_bep = torch.ones_like(use_bep)
    return HcBatch(g=p.g.to(torch.int32), r=p.r.to(torch.int32),
                   q=p.q.to(torch.int32), pang=p.pang,
                   mq=p.mq.to(torch.int32), b=p.b, node=p.node, valid=valid,
                   use_bep=use_bep)


LAUNCHES: Dict[str, int] = {"hc_node_scores": 0}
"""Kernel launches since the last reset_launches()."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def node_scores_plain(batch, t: HcTables, bep, consensus: bool):
    """(c [n_nodes], sum(b)): c = segment_sum(A - b, node) over the rows
    of an HcBatch or of packed views, A = mapping_scores. Node ids
    outside [0, n_nodes) are dropped, as jax.ops.segment_sum drops
    them."""
    if isinstance(batch, HcPacked):
        batch = packed_batch(batch, consensus)
    d = mapping_scores(batch, t, bep, consensus) - batch.b
    n_nodes = t.support.shape[0]
    node = batch.node.long()
    keep = (node >= 0) & (node < n_nodes)
    c = torch.zeros(n_nodes, dtype=d.dtype, device=d.device)
    # segment_sum over node ids
    c.index_add_(0, node.clamp(0, n_nodes - 1),
                 torch.where(keep, d, torch.zeros((), dtype=d.dtype,
                                                  device=d.device)))
    return c, batch.b.sum()


def _ptr(x: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A bool or uint8 flag tensor as contiguous uint8 (a bool tensor is
    viewed, not copied)."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    elif x.dtype != torch.uint8:
        raise ValueError(f"node_scores: flags of dtype {x.dtype}")
    return x.contiguous()


def node_scores(batch, t: HcTables, bep, consensus: bool):
    """(c [n_nodes], sum(b)) of an HcBatch or of packed views (see
    node_scores_plain). CPU tensors run the plain version. CUDA tensors
    launch hc_node_scores_kernel (csrc/haplocart.cu) once, which reads
    the packed buffer in place, or raise."""
    dev = t.support.device
    if dev.type == "cpu":
        return node_scores_plain(batch, t, bep, consensus)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .._native import haplocart_lib

    packed = isinstance(batch, HcPacked)
    M, S = batch.g.shape
    cols = [batch.g, batch.r, batch.q, batch.mq, batch.use_bep, batch.pang,
            batch.node, batch.b, batch.take if packed else batch.valid]
    if any(x.device != dev for x in cols):
        raise ValueError("node_scores: batch and tables on different devices")
    if any(x.shape != (M, S) for x in cols[1:3]) or any(
            x.shape != (M,) for x in cols[3:8]):
        raise ValueError("node_scores: batch columns of different shapes")
    codes = cols[:4]
    if not all(x.dtype == torch.uint8 for x in codes):
        codes = [x.to(torch.int32) for x in codes]
    codes = [x.contiguous() for x in codes]
    i32 = [x.to(torch.int32).contiguous() for x in (batch.pang, batch.node)]
    b = batch.b.to(F64).contiguous()
    if packed:
        use_bep = None if consensus else _bytes(batch.use_bep)
        take, valid = batch.take.to(torch.int32).contiguous(), None
    else:
        use_bep = _bytes(batch.use_bep)
        take, valid = None, _bytes(batch.valid)
    tabs = [x.to(F64).contiguous() for x in (t.qtab, t.imtab, t.match_tab,
                                             t.mapp_tab, t.bg)]
    n_nodes = t.support.shape[0]
    if not M:
        return (torch.zeros(n_nodes, dtype=F64, device=dev),
                torch.zeros((), dtype=F64, device=dev))
    # written whole by the launch, which zeroes them first
    c = torch.empty(n_nodes, dtype=F64, device=dev)
    total_b = torch.empty((), dtype=F64, device=dev)
    lib = haplocart_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hc_node_scores_launch(
            codes[0].element_size(), *[_ptr(x) for x in codes],
            _ptr(use_bep), _ptr(take), _ptr(valid), _ptr(i32[0]),
            _ptr(i32[1]), _ptr(b),
            *[a for x in tabs for a in (_ptr(x), x.shape[0])],
            float(bep), int(bool(consensus)), M, S, n_nodes, _ptr(c),
            _ptr(total_b), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"hc_node_scores kernel launch failed: CUDA error {rc}")
    LAUNCHES["hc_node_scores"] += 1
    return c, total_b


def score_batch(batch: HcBatch, t: HcTables, bep=1e-4,
                consensus: bool = False):
    """final_vec over paths for one batch of mappings."""
    c, total_b = node_scores(batch, t, bep, consensus)
    return total_b + c @ t.support


def score_packed(buf: torch.Tensor, t: HcTables, bep, M: int, S: int,
                 consensus: bool = False):
    """Score hc_columnar.pack_batch's single uint8 buffer (already on the
    tables' device) as it lies: one node_scores over its views, then the
    GEMV."""
    c, total_b = node_scores(unpack(buf, M, S, t.support.dtype), t, bep,
                             consensus)
    return total_b + c @ t.support


def batch_from_alignments(db, alignments, device, max_node_len: int = 0,
                          bucket_m: bool = True) -> Optional[HcBatch]:
    """Build an HcBatch from real GAM alignments (device-scorer input).

    Host prep mirrors pipelines/haplocart.mapping_scalars (same quirks:
    read bases from the read start, per-mapping quality slices, whole-
    read unsupported penalty); the per-base math then runs on device.

    max_node_len=0 (default) sizes the S axis to the batch's longest
    mapping, rounded up to a multiple of 8 (the real HC graph has
    <=8bp nodes, `src/test.cpp:627`, so S=8 there); a positive value
    truncates mappings to it. The M axis is bucketed to the next
    power of two (>= 256) with inert padding rows."""
    from ..graph.reconstruct import reconstruct_graph_sequence
    from ..utils import dna

    qscore = phred.qscore_vec()
    log_q0 = float(np.log(qscore[0]))

    # phase 1: host reconstruction + per-read scalars
    recs = []  # (gcodes, rcodes, qual, size_m, starts, nidx, mq, b_read, bep_flag)
    s_needed = 1
    for a in alignments:
        if a.identity < 1e-10 or not a.path.mappings:
            continue
        graph_seq, read_seq, sizes = reconstruct_graph_sequence(
            db.graph, a.path, a.sequence
        )
        gcodes = dna.encode(graph_seq).astype(np.int32)
        rcodes = dna.encode(read_seq).astype(np.int32)
        L = len(read_seq)
        qual = np.zeros(2 * L + 8, dtype=np.int64)
        q_raw = np.frombuffer(a.quality, dtype=np.uint8)
        qual[: len(q_raw)] = q_raw
        n_map = len(a.path.mappings)
        # per-mapping sizes: sizes is per-edit (reference quirk) but
        # indexed per mapping (`src/update_likelihood.cpp:36`)
        size_m = np.array(
            [sizes[i] if i < len(sizes) else 0 for i in range(n_map)],
            dtype=np.int64,
        )
        starts = np.concatenate([[0], np.cumsum(size_m)[:-1]])
        # unsupported-path penalty over [pos, pos+L) of the padded
        # quality array, via one cumulative sum per read
        logq = np.log(qscore[np.clip(qual, 0, 99)])
        cum = np.concatenate([[0.0], np.cumsum(logq)])
        ends = starts + L
        in_range = np.minimum(ends, len(qual))
        b_read = (
            cum[in_range] - cum[np.minimum(starts, len(qual))]
            + (ends - in_range) * log_q0
        )
        nidx = np.array(
            [m.position.node_id - db.graph.min_id for m in a.path.mappings],
            dtype=np.int32,
        )
        bep_flag = bool((q_raw >= 90).any())
        s_needed = max(s_needed, int(size_m.max(initial=0)))
        recs.append((gcodes, rcodes, qual, size_m, starts, nidx,
                     min(a.mapping_quality, 99), b_read, bep_flag))
    if not recs:
        return None

    S = max_node_len if max_node_len > 0 else -(-s_needed // 8) * 8
    col = np.arange(S)
    rows_g, rows_r, rows_q, rows_v = [], [], [], []
    pang, mq, bvec, node, use_bep = [], [], [], [], []
    # phase 2: padded row assembly at the chosen S
    for gcodes, rcodes, qual, size_m, starts, nidx, mqv, b_read, bf in recs:
        take = np.minimum(size_m, S)
        idx = starts[:, None] + col[None, :]  # [n_map, S]
        v = col[None, :] < take[:, None]
        gpad = np.full(len(gcodes) + S, 255, dtype=np.int32)
        gpad[: len(gcodes)] = gcodes
        g_rows = np.where(v, gpad[np.minimum(idx, len(gpad) - 1)], 255)
        # read row content is shared: the first `take` chars of the
        # read from its start (reference quirk), masked per mapping
        r_base = np.full(S, 255, dtype=np.int32)
        r_base[: min(S, len(rcodes))] = rcodes[:S]
        r_rows = np.where(v, r_base[None, :], 255)
        qpad = np.zeros(len(qual) + S, dtype=np.int32)
        qpad[: len(qual)] = qual
        q_rows = np.where(v, qpad[np.minimum(idx, len(qpad) - 1)], 0)
        n_map = len(size_m)
        rows_g.append(g_rows)
        rows_r.append(r_rows)
        rows_q.append(q_rows)
        rows_v.append(v)
        node.append(nidx)
        pang.append(db.pangenome_base[nidx].astype(np.int32))
        mq.append(np.full(n_map, mqv, dtype=np.int32))
        bvec.append(b_read)
        use_bep.append(np.full(n_map, bf, dtype=bool))

    g = np.concatenate(rows_g)
    M = len(g)
    pad = 0
    if bucket_m:
        target = 256
        while target < M:
            target *= 2
        pad = target - M

    def _pad(x, fill=0):
        if pad:
            shape = (pad,) + x.shape[1:]
            x = np.concatenate([x, np.full(shape, fill, x.dtype)])
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return HcBatch(
        g=_pad(g, 255),
        r=_pad(np.concatenate(rows_r), 255),
        q=_pad(np.concatenate(rows_q)),
        pang=_pad(np.concatenate(pang)),
        mq=_pad(np.concatenate(mq)),
        b=_pad(np.concatenate(bvec).astype(np.float64)),
        node=_pad(np.concatenate(node)),
        valid=_pad(np.concatenate(rows_v), False),
        use_bep=_pad(np.concatenate(use_bep), False),
    )


def device_tables(db) -> HcTables:
    """The DB's scorer tables on its device, built once and cached."""
    tables = getattr(db, "_device_tables", None)
    if tables is None:
        tables = db._device_tables = make_tables_from_db(db, db.device)
    return tables


def score_alignments_device(
    db,
    alignments,
    background_error_prob: float = 1e-4,
    is_consensus_fasta: bool = False,
    devices=None,
) -> np.ndarray:
    """Device scorer for alignment objects: the full
    `src/HaploCart.cpp:408-421` batch on db.device
    (batch_from_alignments -> score_batch), replacing the host
    per-alignment loop (pipelines/haplocart.score_alignments, kept as
    the --precise f64 oracle). devices, a list: the mapping rows split
    over them and the parts merged on the first
    (parallel/mesh.score_batch_split)."""
    from ..utils import guards

    batch = batch_from_alignments(
        db, alignments, "cpu" if devices is not None else db.device,
        bucket_m=devices is None,
    )
    if batch is None:
        raise RuntimeError("[HaploCart] Error, no reads mapped")
    if is_consensus_fasta:
        # consensus mode: eps comes from bep for every base
        # (`src/HaploCart.cpp:394-399` sets the flag up front)
        batch.use_bep = torch.ones_like(batch.use_bep)
    if devices is not None:
        from ..parallel import mesh

        out = mesh.score_batch_split(
            batch, mesh.hc_tables(db, devices), background_error_prob,
            is_consensus_fasta,
        )
    else:
        out = score_batch(batch, device_tables(db),
                          bep=background_error_prob,
                          consensus=is_consensus_fasta)
    out = out.cpu().numpy().astype(np.float64)
    guards.check_finite(out, "haplocart final_vec (device)")
    return out
