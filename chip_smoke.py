#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (vgan_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device  — the card's name, and its name and power limit from
   nvidia-smi; no CUDA device is an error.
2. build   — the native host library (g++, vgan_tpu_torch/cpp/),
   csrc/sw.cu, csrc/tree_mcmc.cu, csrc/keelime.cu, csrc/abundance_mcmc.cu,
   csrc/haplocart.cu, csrc/euka.cu and csrc/patristic.cu (nvcc, sm_90a)
   from the checkout's sources, and the measurement builds of
   csrc/haplocart.cu and csrc/euka.cu (-DVGAN_HC_PHASE_CLOCKS,
   -DVGAN_EUKA_PHASE_CLOCKS), the compilers started together; seconds
   of each build; `cuobjdump -sass` of the SW library, which must show
   Hopper's DPX max instructions (VIMNMX3, VIADDMNMX) in every
   instantiation of both kernels, and whose DP step (the straight-line block holding the most VIMNMX3, one
   a cell) must issue at least the integer-ALU operations a cell that
   the bound counts; the step's operations a cell on each pipe are
   logged.
3. kernels — each CUDA entry point of csrc/sw.cu against its plain
   PyTorch version on the card, exact equality required (every score is
   a small integer; hashes are 32-bit integers):
     sw_scores on tests/test_sw_pallas.py's random sets (B=16, R=64,
     W=128, seeds 0-2), at the mapper's shape (B=32,768, R=128, W=192)
     and on 1,000-bp reads (B=2,048, R=1,024, W=1,152: four bands of
     rows); gather_score_hash on a random 86 MB path-code pool with both
     strands, padding rows and int32/int64 aux (M=32,768), on a small
     batch (M=1,024) and on 1,000-bp reads (M=2,048, Rmax=1,024). Each
     shape is timed (CUDA events), kernel and plain version, beside its
     bound (bound_ms below: the DP cells' operations on the pipe that
     limits them, or the bytes moved over 3.35 TB/s, whichever takes
     longer). Each shape is also timed on the device alone, its calls
     queued behind a spin kernel so that the wrapper's host work is
     hidden (no profiler here: once torch.profiler has traced the card,
     every later launch of the process is slower).
4. e2e     — a reference-free world at the real HaploCart DB's shape
   (5,179 haplotype paths over a seeded random 16,569-bp backbone, 600
   variants), saved as graph.npz; 8,000 100-bp reads of haplotype 5 as
   FASTQ; `vgan_tpu_torch.cli haplocart --device cuda` once to warm up
   and twice timed. The TSV must name hap5, the SW kernel and
   hc_node_scores_kernel must have been launched by those runs, each
   gather_score_hash call of the warm-up run must equal the plain version
   (and is timed beside its bound), each score_packed call of the warm-up
   run (the likelihood step) must equal node_scores_plain on the card
   (sum(b) and final_vec to rtol 1e-12, c to 1e-12 of each node's sum of
   |A - b|, as the f64 atomics reorder a node's sum) and is timed beside
   its bound
   (hc_bound_ms), beside the plain op chain, the GEMV and the whole call,
   with its phase split from the measurement build (the main kernel's
   clock64 cycles in each phase, summed over rows: the issue of the next
   tile's loads, the table gathers, the S terms, the atomic add),
   the calls' sum logged as a share of map+score, and final_vec's argmax
   must equal the `--precise` host oracle's on the same reads. Then the mapper's object path (BatchedMapper.
   _map_reads_obj, the oracle of the production path, whose windows go
   through sw_scores) on 1,000 of the reads: sw_scores launched, every
   alignment equal to the production path's, each call equal to plain
   and timed.
5. euka    — a reference-free world at the real euka DB's width: 334
   taxa (`src/MCMC.cpp:1193`'s 1/334), each a 4-haplotype graph over its
   own random 16,384-bp backbone (40 variants, 8-bp nodes), merged over
   disjoint node ranges and saved as euka_db.{npz,clade,bins} with 21
   equal bins at entropy 1.5 plus a whole-range bin at 0.5 per taxon,
   and a C>T / G>A damage profile pair; 8,000 64-bp reads of haplotype 0
   of three taxa at 5,600 / 2,000 / 400 (70 / 25 / 5 %, the mixture of
   `src/test.cpp:1026-1099`). `vgan_tpu_torch.cli euka --device cuda`
   with the reference's default gates and a 10,000-step MCMC, once to
   warm up and twice timed: each run must detect exactly the three
   planted taxa, put their posterior medians in [0.65, 0.75],
   [0.20, 0.30] and [0.02, 0.08], write every output file, and launch
   the SW kernel and abundance_mcmc_segment_kernel. The warm-up run's
   chain segment (9,899 steps of the detected taxa): the kernel against
   run_segment_plain on the card (rtol 1e-12, and the same accepted
   steps, replayed from both proposals), timed a step beside its bound
   (f64_bound_ms), its acceptance and the steps a round of its window,
   and its serial floor (the same steps at T = 1, every step accepted),
   the plain version once, and one CUDA-graph capture of the plain
   version's ops replayed (the library comparator, never on the path);
   a high-acceptance chain of the same shape (4 / 3 / 2 reads) against
   the plain version, timed; and the window sweep: the floor, the
   segment and synthetic chains at T = 16 and 334 at every window the
   kernel takes (1..8 consumer warps), bit-equal at each, timed a step
   and a round.
   Each call of the warm-up run to euka's per-base scorer
   (pipelines/euka.score_batch; every run must launch euka_score_kernel)
   against score_batch_plain on the card (rtol 1e-12), timed by events
   and on the device alone beside its bound (euka_work: the f64
   instructions the function needs for the call's valid columns by
   class, against its bytes), the plain version and its ops as one CUDA graph replayed (the
   library comparator, never on the path), its launch shape and
   occupancy, and a clock64 phase split from the measurement build; the
   calls' share of map+score logged; then a synthetic 1,000-bp batch
   (B = 2,048, L = 1,024) the same way, and the same batch with half of
   its reads reverse (both orientations, as euka's own batches hold).
   Then the reads mapped on the card and on the CPU
   (every table field equal), each gather_score_hash call of the card's
   mapping (euka's shapes: 64-row read bucket, its own window and row
   buckets) against the plain version exactly, timed beside its bound; the
   scorer and the MCMC on the card against the same code on the CPU
   (rtol 1e-12; counts and detected taxa equal), and one torch.profiler
   pass over a CLI run for the device time, the idle share and the peak
   device memory.
6. soibean — a reference-free world at a family's scale: a seeded random
   128-leaf tree (255 nodes, branch lengths in [0.01, 0.3]) as Newick,
   one path a tree node over a seeded random 16,569-bp backbone of 2-bp
   nodes, each branch bringing 150 single-base variants a unit of
   length (tests/_torch_world.py:build_tree_graph), saved as
   <prefix>.npz with soibean_db.baseFreq and tree_dir/<prefix>.new.dnd;
   4,000 64-bp reads of the three leaves with the most private variants
   at 2,400 / 1,200 / 400. `vgan_tpu_torch.cli soibean --device cuda
   --chains 4 --iter 50000 --burnin 7500` once to warm up and twice
   timed: the signature paths must be exactly the planted leaves, every
   output file for k = 1..3 written, and at k = 3 the chain of the
   highest log-likelihood must end on the planted leaves (or their
   parents) with mean proportions within 0.15 of 0.6 / 0.3 / 0.1; both
   kernels launched. The warm-up run's SW kernel calls against plain
   and timed; then tree_mcmc_segment_kernel against its plain version
   on the card and on the CPU over 1,000 steps of the run's own k-sweep
   batch (200 burn-in steps, 800 after it; node ids exact, floats to
   rtol 1e-10) at every cluster size the wrapper can choose for the
   batch (1, 2, 4 and 8 CTAs a row for its 12 rows on an H100), the
   plain versions run once; at each size timed a step post-burn-in and
   in burn-in beside its bound and the serial floor (the same steps with
   R cut to 32 reads a CTA); the plain version a step on the card over
   200 steps; every run must launch patristic_series_kernel too. Then
   that kernel at the benchmark cell's shape (425,000 chain-like states
   of a source, the 128-leaf tree of seed 7): its series bit-equal to
   the plain version's and the held host function's, the kernel timed by
   events and on the device alone beside its bound (6 f64 instructions a
   leaf term and 2 a state, against 20 bytes a state), the whole wrapper
   call, the plain version and the held function on the host clock (one
   line). Phase 6 runs before phase 5, whose
   profiler pass slows every later launch of the process.
7. keelime — a reference-free world at a mitogenome's scale: a seeded
   random 16,569-bp backbone with four haplotypes (40 variants, 8-bp
   nodes; tests/test_scale_stress.py:211-216's world), saved as
   graph.npz; 12,000 64-bp reads of haplotype 1 (~46x) and the C>T / G>A
   damage profiles of tests/_torch_world.py. `vgan_tpu_torch.cli keelime
   --device cuda -p hap1 --deam5p .. --deam3p ..` (the RY-space route of
   aDNA) once to warm up and twice timed: each run must write the four
   outputs, give a consensus of >= 0.9 x the haplotype's length with
   >= 0.8 x of it called (not N), and launch the SW kernel, the warp
   overlap kernel in find_overlaps and at least one merge pass, and the
   block overlap kernel in at least one merge pass (find_overlaps' reads
   are all short: its call skips the block kernel); keelime_e2e_reads_per_s is the reads over the map +
   analyse + assemble + consensus stages. One run with `--device cpu`
   must write the same four outputs (.gz decompressed). Every
   overlap_best_indexed call of the warm-up run (find_overlaps' candidate
   pairs, then each merge pass): the warp and block kernels each alone on
   its length class (where it has pairs) against its plain version on the
   card, the call against both plain versions, the native host scan and
   the library's conv1d, all exactly, each kernel's max_abs_err taken
   over its own pairs; each kernel timed beside its bound
   (overlap_bound_ms), and the whole call. Some
   merge pass must hold pairs for the block kernel (contigs longer than
   L_WARP), and some its mitogenome-length contigs: on the call of those
   with the most long pairs the block kernel (one thread-block cluster
   of G CTAs a pair) runs at the cluster size it chooses and forced to
   G = 1, 2, 4, 8 and 16, each bit-equal to plain_block_scan and timed
   beside the bound. Then `map --device cuda` and
   `map --device cpu` on the same reads must write equal alignments, and
   `duprm` must run on the card's GAM. Phase 7 runs after phase 6 and
   before phase 5.
8. multi   — multi-process and multi-card runs (parallel/), after phase
   7 and before phase 5: `vgan_tpu_torch.cli haplocart --device cuda
   --coordinator 127.0.0.1:<free port> --nproc 2 --procid {0,1}` on
   phase 4's world, as two processes on the one card (each its own
   CUDA context; gloo carries the accumulator), each through the rank
   runner tests/_torch_rank.py, which runs the CLI's main and prints a
   rank line with its own kernel launches and stage seconds and saves
   host 0's final_vec. Each rank must launch gather_score_hash_kernel
   and hc_node_scores_kernel;
   host 0 alone writes the TSV (one header, one row: hap5 and host 0's
   own read count); host 0's final_vec must equal, to rtol 1e-10, the
   sum over the two halves of the reads of the single-process scorer on
   the card on each half mapped, sorted and deduplicated alone. The
   wall time of the two-rank run and each rank's map and score seconds
   are logged. Then the split steps of parallel/mesh.py over the device
   list [cuda:0, cuda:0]: HaploCart's columnar scorer on phase 4's
   deduplicated table against the single-card scorer (rtol 1e-12), one
   hc_node_scores_kernel launch a part; the same scorer over dp x tp
   = 1 x 2 and 2 x 2 grids of cuda:0 (the support matrix's paths split
   over the tp columns): final_vec to rtol 1e-12 of one card's with the
   same argmax, one launch a device of the grid, timed; and
   soibean's k-sweep batch of phase 6 split in two halves of rows over
   MULTI_ITER steps (MULTI_BURN of burn-in) against the unsplit batch
   (node ids exact, floats to rtol 1e-10), each half launching the tree
   kernel. A real two-card run needs a machine with two cards.
9. bench   — the port's bench (vgan_tpu_torch/bench.py, what `cli bench`
   runs) at full size in this process, after phase 8 and before phase 5,
   on phase 4's real-DB world (the same graph, bench.realdb_graph, and
   its mapper, so the bench builds neither), every kernel's launch
   count set to 0 just before it: its line is printed as `bench {...}`
   (the card's name and power limit in its `card` field); every name of
   bench.FIELD_ORDER and of the additions must be in it, its three
   agreement flags true, every metric finite and above 0, and each of
   the eight kernels launched. Calls are kept by the bench phase that
   makes them (BenchCalls). The sw phase's last scores must equal
   sw_scores_plain; the SW kernel is timed at its shape (B=4,096,
   R=128, W=256) beside its bound, by events and on the device alone;
   gather_score_hash_kernel at realdb_mapping's first call (a
   4,096-read chunk of the 5,179-path world); hc_node_scores_kernel at
   device_step's batch, rebuilt as the phase builds it (M = 196,608, S
   = 8; the GEMV over the 11,825 x 5,179 f64 support matrix and the
   whole score_batch beside it); euka_score_kernel at every scorer call
   of euka_realdb (100-bp reads; rtol 1e-12, NaN and inf where the
   plain version has them), its largest timed; both overlap kernels at
   every overlap call of the keelime phase (exactly equal to
   plain_indexed), the calls with the most short and the most long
   pairs checked and timed as phase 7 does;
   abundance_mcmc_segment_kernel at euka_mcmc's segment (T = 6) and
   tree_mcmc_segment_kernel over SB_TIMED_STEPS steps of soibean_mcmc's
   first post-burn-in segment (4 chains of k = 2, R = 200, 255 nodes),
   each held against its plain version on the card and timed beside its
   bound.

The kernels line lists the nine kernels, the first eight with phase 9's launches
added to its count and its row at the bench's shape (`bench_shape`):
gather_score_hash_kernel's
launches are those of the HaploCart, soibean, keelime and euka runs
and of the two ranks of phase 8 together, sw_scores_kernel's those of
the object path, tree_mcmc_segment_kernel's those of the soibean runs
and of phase 8's split chains, the two
overlap kernels' those of the keelime runs,
abundance_mcmc_segment_kernel's those of the euka runs and
hc_node_scores_kernel's those of the HaploCart runs, phase 8's two ranks,
its split scorer and its tp grids, euka_score_kernel's those of the
euka runs (each counted from 0 just
before its runs); ms, plain_ms and the bound are at the mapper's shape
(sw_scores: B=32,768 full-length pairs; gather_score_hash: the pool
batch), for the tree kernel over 200 post-burn-in steps of the soibean
k-sweep batch (12 rows, Kmax 3, 4,000 reads, 255 paths) at the cluster
size the wrapper chooses, for overlap_warp_kernel at the find_overlaps
batch of the keelime warm-up run and for overlap_best_kernel at the
long pairs of the largest merge batch that has some (each alone on its
class, with the library's grouped conv1d on the same pairs as
library_ms, and the cluster size it ran at; then the mitogenome-length
call's long pairs, ms and bound at its chosen cluster size and ms at
each forced size), for the chain over the euka warm-up run's segment
(library_ms: the CUDA-graph replay; its window, acceptance, steps a
round, the high-acceptance chain's time a step and the sweep's times by
window) and for the likelihood step at the HaploCart warm-up run's
largest call (no library call computes it; its device time and phase
split), for euka's scorer at the euka warm-up run's largest call
(library_ms: the CUDA-graph replay; the other call's ms, the launch
shape, the phase split and the two 1,000-bp batches' numbers beside
it), and for the patristic-distance series at the cell's shape (its
launches those of the soibean runs; no phase of the bench launches it).
Every timing line names the card and its power limit. The
second-to-last lines are the nvidia-smi line and one JSON object
describing the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
try:
    # the card's peak rates and the bound of an SW call
    # (vgan_tpu_torch/utils/roofline.py: 5 of a DP cell's 9 integer
    # operations on the 64-lane ALU pipe), shared with the bench
    from vgan_tpu_torch.utils.roofline import (
        ALU_OPS_PER_CELL, CLOCK_HZ, HBM_BYTES_PER_S, SM_LANES, SMS)
    from vgan_tpu_torch.utils.roofline import sw_bound_ms as bound_ms
except ImportError:
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(vgan_tpu_torch/ not found beside it)")
KERNEL_SOURCE = "vgan_tpu_torch/csrc/sw.cu"
REPLACES = "vgan_tpu/mapper/sw_pallas.py:191"  # the pallas_call of sw_scores
# the long-read shape: 1,000-bp reads in a 1,024-row bucket (four
# 256-row bands) and 1,152-column windows
LONG_B, LONG_R, LONG_W, LONG_READ_LEN = 2048, 1024, 1152, 1000
# the mapper's object path (the oracle of the production path), driven
# on this many of HaploCart's reads
OBJECT_PATH_READS = 1000
N_HAPS, N_READS, READ_LEN, HAP = 5179, 8000, 100, 5
# the mapper's SW shape: a 4,096-read chunk x 8 candidates, 128-row
# read bucket, 192-column window bucket
MAP_B, MAP_R, MAP_W = 32768, 128, 192
# euka: taxa, backbone bp, haplotypes and variants per taxon, bins
EUKA_TAXA, EUKA_BP, EUKA_HAPS, EUKA_VARIANTS, EUKA_BINS = (
    334, 16384, 4, 40, 21)
EUKA_READ_LEN = 64
# (taxon, reads, window of its posterior median)
EUKA_MIX = ((17, 5600, (0.65, 0.75)), (160, 2000, (0.20, 0.30)),
            (301, 400, (0.02, 0.08)))
EUKA_ITER, EUKA_BURNIN = 10000, 100
EUKA_GATES = ["--minMQ", "29", "--minFrag", "10", "--minBins", "6",
              "--maxBins", "0", "--entropy", "1.17", "--iter", str(EUKA_ITER),
              "--burnin", str(EUKA_BURNIN)]
# the chain steps that run: burn-in proposals are never evaluated
EUKA_STEPS = EUKA_ITER - EUKA_BURNIN - 1
# soibean: a family-scale tree (leaves; 2 * leaves - 1 nodes), one path a
# tree node over a mitogenome-length backbone of 2-bp nodes with variants
# along the branches (sites a unit of branch length), 64-bp reads of the
# three leaves with the most private variants
TREE_SOURCE = "vgan_tpu_torch/csrc/tree_mcmc.cu"
TREE_REPLACES = "vgan_tpu/infer/tree_mcmc.py:647"  # _run_segment
SB_LEAVES, SB_BP, SB_SITES_PER_UNIT, SB_NODE_LEN = 128, 16569, 150, 2
SB_PREFIX, SB_READ_LEN = "family", 64
SB_MIX = (2400, 1200, 400)  # reads of the three planted leaves
SB_SHARES = (0.6, 0.3, 0.1)
# cut from 100,000 / 15,000 when phase 9 came in (the smoke's budget)
SB_ITER, SB_BURNIN, SB_CHAINS = 50000, 7500, 4
# the kernel against its plain versions: steps of the burn-in walk, then
# steps of the post-burn-in walk from the carry; the plain version's
# time a step and the kernel's over SB_TIMED_STEPS
SB_CHECK_BURN, SB_CHECK_POST, SB_TIMED_STEPS = 200, 800, 200
# soibean's patristic-distance series at the benchmark cell's shape: one
# chain source's 425,000 recorded states (iterations 75,001..500,000) on the
# 128-leaf tree of seed 7; its bound counts 6 f64 instructions a leaf term
# (the subtraction, the compare, two additions, the square, the
# accumulation) and 2 a state, and 20 bytes a state (node, position, value)
PT_SOURCE = "vgan_tpu_torch/csrc/patristic.cu"
PT_STATES, PT_LEAVES, PT_TREE_SEED = 425_000, 128, 7
PT_OPS_PER_TERM, PT_OPS_PER_STATE, PT_BYTES_PER_STATE = 6, 2, 20
# f64 multiply-adds on an H100 SXM: 67 TFLOP/s in the tensor cores
# (NVIDIA's data sheet), the largest f64 rate the card has
F64_FMA_PER_S = 67e12 / 2
# keelime: a mitogenome-length backbone with four haplotypes (40 variants,
# 8-bp nodes; tests/test_scale_stress.py:211-216's world), 64-bp reads of
# one haplotype (~46x), the C>T / G>A damage profiles
KL_SOURCE = "vgan_tpu_torch/csrc/keelime.cu"
# the XLA program the kernel replaces: _overlap_scores_device
KL_REPLACES = "vgan_tpu/pipelines/keelime_device.py:41"
KL_BP, KL_HAPS, KL_VARIANTS, KL_HAP, KL_READS, KL_READ_LEN = (
    16569, 4, 40, 1, 12000, 64)
# an overlap cell is a table lookup and an integer add: 2 lane operations
OVERLAP_OPS_PER_CELL = 2
# a merge call's contigs count as mitogenome-length from this share of
# the backbone on (the cluster-size sweep's call)
MITO_FRACTION = 0.9
# phase 8: the two ranks' time limit, and the chain split's steps (as
# many as phase 6's kernel check runs)
RANK_TIMEOUT_S = 300
MULTI_ITER, MULTI_BURN = 1000, 200
# euka's abundance chain and HaploCart's likelihood step
AM_SOURCE = "vgan_tpu_torch/csrc/abundance_mcmc.cu"
AM_REPLACES = "vgan_tpu/infer/abundance_mcmc.py:60"  # _run_seg
HC_SOURCE = "vgan_tpu_torch/csrc/haplocart.cu"
# score_packed's mapping_scores + segment_sum (score_batch's at :63-96)
HC_REPLACES = "vgan_tpu/pipelines/haplocart_device.py:99"
# f64 instructions: 64 FP64 lanes an SM (33.5 TFLOP/s with a DFMA as two
# operations, NVIDIA's data sheet). Counted from the sm_90a SASS
# (cuobjdump -sass): a log is 29 of them (one MUFU.RCP64H, DADD / DMUL /
# DFMA), an exp 19, a division 9 on its fast path. hc_node_scores_kernel:
# 36 a position that counts (1 - eps twice, p_obs, (1 - pc) * bg,
# pc * p_obs, their sum, the log, A +=) and 3 a row (pc, A - b); the
# chain: 62 a taxon a step (x, exp, the sum, the division, log, n * log
# and its sum) and 40 a step (the three butterflies, the ratio's exp,
# the compares).
F64_LANES = 64
HC_F64_OPS_PER_POSITION, HC_F64_OPS_PER_ROW = 36, 3
AM_F64_OPS_PER_TAXON, AM_F64_OPS_PER_STEP = 62, 40
# euka's per-base scorer: the f64 instructions the function needs a
# valid column of each class, a log, an exp and a division as above, the
# column's two row-sum adds included (not what euka_score_kernel issues).
# ACGT: pd x ttr for the three other bases (3), the four diagonal
# compares choosing the 5' or 3' row (4), pre x D (4 multiplies and 12
# multiply-adds), max(post, 1e-300) (4 compares), 1 - qv (1) and qv / 3
# (9), sum_d max(post_d, 1e-300) err_d (a multiply and 3 multiply-adds)
# and its log (29), which equals the logsumexp of the logs: 72. A softclip
# column: log1p(-qv) and its negation (32), or log(qv / 3) (40). N, gap
# and rare columns: 2. A row: 1 - pd, times 0.001 and the log, 31.
EUKA_SOURCE = "vgan_tpu_torch/csrc/euka.cu"
EUKA_REPLACES = "vgan_tpu/pipelines/euka.py:111"  # _score_batch_impl
EUKA_OPS_ACGT, EUKA_OPS_SOFT_THIRD, EUKA_OPS_SOFT_OTHER = 72, 32, 40
EUKA_OPS_OTHER, EUKA_OPS_ROW = 2, 31
# the scorer at a synthetic 1,000-bp read batch: rows, the column bucket
EUKA_LONG_B, EUKA_LONG_L = 2048, 1024


START = time.perf_counter()


def log(msg: str) -> None:
    """Prints msg behind the seconds since the script started."""
    print(f"[{time.perf_counter() - START:5.0f} s] {msg}", flush=True)


# ----------------------------------------------------------------- timing
def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def f64_bound_ms(ops: int, nbytes: int):
    """(least milliseconds, "operations" or "bytes") for `ops` f64
    instructions over 132 SMs x 64 FP64 lanes at 1.98 GHz against
    `nbytes` moved over the HBM rate, whichever takes longer."""
    t_ops = ops / (SMS * F64_LANES * CLOCK_HZ)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _close(label, got, want, rtol):
    """Raises unless got is within rtol of want elementwise (equal where
    want is 0 or not finite); returns the largest absolute difference."""
    import torch

    try:
        torch.testing.assert_close(got, want, rtol=rtol, atol=0,
                                   equal_nan=True)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None
    fin = torch.isfinite(want)
    return float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sw_work(read, win, read_len, win_len):
    """(DP cells, hashed columns, bytes) of one sw_scores call: the
    cells of rows 1..min(rlen, R) by columns < min(wlen, W), no hash;
    every input read once and the [B] f32 output written once."""
    R, W = read.shape[1], win.shape[1]
    rows = read_len.long().clamp(0, R)
    cols = win_len.long().clamp(0, W)
    cells = int((rows * cols).sum())
    return cells, 0, nbytes(read, win, read_len, win_len) + 4 * read.shape[0]


def gsh_work(pc, rm, rl, ax, Wmax):
    """(DP cells, hashed columns, bytes) of one gather_score_hash call.
    Every row hashes all Wmax columns. Bytes: the live window bytes, the
    read matrix, lengths, aux, the two power tables and the three [M]
    outputs."""
    M, Rmax = ax.shape[1], rm.shape[1]
    wl = ax[2].long().clamp(0, Wmax)
    L = rl.long()[ax[0].long()].clamp(0, Rmax)
    cells = int((L * wl).sum())
    moved = (int(wl.sum()) + nbytes(rm, rl, ax) + 8 * Wmax + 12 * M)
    return cells, M * Wmax, moved


# a spin kernel of this many cycles (>= 50 ms at the H100's <= 1.98 GHz)
# holds the card while the host queues the calls that queued_ms times
SPIN_CYCLES = 100_000_000


def queued_ms(fn, reps: int):
    """Mean device milliseconds per call of fn with the host's work
    hidden: the calls are queued behind a spin kernel, so they run back
    to back on the card (a call's kernel and any conversion it launches,
    without the wrapper's host time). None if queueing outlasted the
    spin."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps if queued_s < 0.04 else None


class Clock:
    """Times the SW wrappers at each shape beside their bound, naming the
    card (`smi`) in every line."""

    def __init__(self, smi: str):
        self.smi = smi

    def timed(self, label, fn, plain_fn, work, reps=20, plain_reps=2):
        """Milliseconds per call of the wrapper (CUDA events), its device
        time alone (queued_ms) and the plain version's, beside the bound
        of `work` = (cells, hashed columns, bytes); logs one line."""
        cells = work[0]
        ms = cuda_ms(fn, reps=reps)
        dev_ms = queued_ms(fn, reps)
        plain = cuda_ms(plain_fn, reps=plain_reps)
        bms, by = bound_ms(*work)
        dev_txt = ("device time not measured" if dev_ms is None else
                   f"on the device alone {dev_ms:.4f} ms = "
                   f"{100 * bms / dev_ms:.1f} %")
        log(f"{label}: kernel {ms:.4f} ms a call ({cells / ms / 1e6:.1f} "
            f"GCUPS, {100 * bms / ms:.1f} % of the {bms:.4f} ms bound, "
            f"{by}-bound; {dev_txt}), plain {plain:.3f} ms; "
            f"{cells} cells; on {self.smi}")
        return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, cells=cells)


# ----------------------------------------------------------------- phase 1
def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(f"nvidia-smi: {smi}")
    return name, smi


# ----------------------------------------------------------------- phase 2
def phase_build():
    """The eight native libraries and the measurement builds of the
    likelihood step and euka's scorer, their compilers all started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    from vgan_tpu_torch import _native

    builds = (("host", _native.host_lib), ("sw.cu", _native.sw_lib),
              ("tree_mcmc.cu", _native.tree_mcmc_lib),
              ("keelime.cu", _native.keelime_lib),
              ("abundance_mcmc.cu", _native.abundance_mcmc_lib),
              ("haplocart.cu", _native.haplocart_lib),
              ("euka.cu", _native.euka_lib),
              ("patristic.cu", _native.patristic_lib),
              ("haplocart.cu, phase clocks",
               _native.haplocart_clocks_lib),
              ("euka.cu, phase clocks", _native.euka_clocks_lib))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(build) for name, build in builds}
        libs = {name: f.result() for name, f in futures.items()}
    for name, lib in libs.items():
        log(f"build {name}: {os.path.relpath(lib._name, HERE)}")
    log(f"builds: {time.perf_counter() - t0:.2f} s together; compile "
        f"seconds each {json.dumps(_native.BUILD_SECONDS)}")
    return dict(_native.BUILD_SECONDS), check_sass(libs["sw.cu"]._name)


# sm_90 pipes of the opcodes a DP step issues: the integer ALU pipe (64
# lanes an SM) and the FMA pipe (integer adds and multiply-adds); the
# rest (shared-memory, shuffle) are neither
ALU_PIPE = {"ISETP", "SEL", "LOP3", "PLOP3", "VIADDMNMX", "VIMNMX3",
            "VIMNMX", "IMNMX", "IADD3", "SHF", "PRMT", "LEA", "MOV", "P2R",
            "R2P"}
FMA_PIPE = {"VIADD", "IMAD"}
# opcodes that end a straight-line block
BLOCK_ENDS = {"BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC",
              "BAR"}


def step_mix(ops):
    """Operations a DP cell on each pipe, in the straight-line block of
    `ops` (one function's opcodes in order) that holds the most VIMNMX3:
    a DP step's cells, one VIMNMX3 each."""
    from collections import Counter

    blocks, cur = [], []
    for op in ops:
        if op in BLOCK_ENDS:
            blocks.append(cur)
            cur = []
        else:
            cur.append(op)
    blocks.append(cur)
    step = Counter(max(blocks, key=lambda b: b.count("VIMNMX3")))
    cells = step["VIMNMX3"]
    alu = sum(n for op, n in step.items() if op in ALU_PIPE)
    fma = sum(n for op, n in step.items() if op in FMA_PIPE)
    return dict(cells=cells, alu=alu / cells, fma=fma / cells,
                other=(sum(step.values()) - alu - fma) / cells)


def check_sass(lib_path):
    """`cuobjdump -sass` of the SW library: every instantiation of both
    kernels must carry Hopper's DPX instructions (VIMNMX3, VIADDMNMX),
    not emulated max chains, and its DP step must issue at least
    ALU_OPS_PER_CELL integer-ALU operations a cell (else the bound is one
    the kernel could beat). Returns the counts per kernel and the step's
    operations a cell on each pipe."""
    import re
    from collections import Counter

    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = os.path.join(cuda_home, "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    ops, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"(sw_scores_kernel|gather_score_hash_kernel)"
                          r"ILi(\d+)E", m.group(1))
            cur = f"{k.group(1)}<{k.group(2)}>" if k else None
            if cur:
                ops[cur] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if cur and m:
            ops[cur].append(m.group(1))
    want = [f"{n}<{k}>" for n in ("sw_scores_kernel",
                                  "gather_score_hash_kernel")
            for k in range(1, 9)]
    counts = {f: Counter(ops.get(f, ())) for f in want}
    bad = [f for f in want
           if not counts[f]["VIMNMX3"] or not counts[f]["VIADDMNMX"]]
    if bad:
        raise AssertionError(f"SASS without DPX max instructions: {bad}")
    keep = ("VIMNMX3", "VIADDMNMX", "SHFL", "LDS", "REDUX")
    summary = {f: {op: counts[f][op] for op in keep} for f in want}
    for f in want:
        summary[f]["step_per_cell"] = step_mix(ops[f])
    low = [f for f in want
           if summary[f]["step_per_cell"]["alu"] < ALU_OPS_PER_CELL]
    if low:
        raise AssertionError(f"DP step below {ALU_OPS_PER_CELL} ALU-pipe "
                             f"operations a cell (restate the bound): {low}")
    log("SASS (cuobjdump -sass): every kernel instantiation uses DPX and "
        f"issues >= {ALU_OPS_PER_CELL} ALU-pipe operations a DP cell; "
        "K=4: " + json.dumps({f: summary[f] for f in want if "<4>" in f}))
    return summary


# ----------------------------------------------------------------- phase 3
def make_batch(rng, B=16, R=64, W=128):
    """tests/test_sw_pallas.py:_make_batch, re-created: reads planted in
    their windows with 5% substitutions."""
    import numpy as np

    read = np.full((B, R), 255, dtype=np.int32)
    win = np.full((B, W), 255, dtype=np.int32)
    rlen = rng.integers(20, R, size=B).astype(np.int32)
    wlen = rng.integers(60, W, size=B).astype(np.int32)
    for b in range(B):
        w = rng.integers(0, 4, size=wlen[b])
        win[b, : wlen[b]] = w
        start = (rng.integers(0, max(1, wlen[b] - rlen[b]))
                 if wlen[b] > rlen[b] else 0)
        r = w[start : start + rlen[b]].copy()
        if len(r) < rlen[b]:
            r = np.concatenate([r, rng.integers(0, 4, size=rlen[b] - len(r))])
        mut = rng.random(rlen[b]) < 0.05
        r[mut] = rng.integers(0, 4, size=int(mut.sum()))
        read[b, : rlen[b]] = r
    return read, win, rlen, wlen


def mapper_shaped_batch(rng, B, R, W, L=READ_LEN):
    """Pairs as the mapper makes them: L-bp reads with ~1% errors
    planted in windows of L + 50 .. W columns; 255-padded to R and W."""
    import numpy as np

    win = rng.integers(0, 4, size=(B, W)).astype(np.int32)
    wlen = rng.integers(L + 50, W + 1, size=B).astype(np.int32)
    win[np.arange(W)[None, :] >= wlen[:, None]] = 255
    start = rng.integers(0, wlen - L + 1)
    idx = start[:, None] + np.arange(L)[None, :]
    read = np.full((B, R), 255, dtype=np.int32)
    planted = np.take_along_axis(win, idx, axis=1)
    err = rng.random((B, L)) < 0.01
    planted[err] = rng.integers(0, 4, size=int(err.sum()))
    read[:, :L] = planted
    rlen = np.full(B, L, dtype=np.int32)
    return read, win, rlen, wlen


def pool_batch(rng, aux_dtype, P=86_000_000, n_reads=4096, n_pad=2048,
               M=MAP_B, Rmax=MAP_R, Wmax=MAP_W, read_len=READ_LEN):
    """gather_score_hash inputs at the mapper's shape: a random path-code
    pool, reads planted in it on both strands, candidate windows around
    the plants (and random ones) of read_len + 48 .. Wmax columns, and
    padding rows (wlen 0)."""
    import numpy as np

    pool = rng.integers(0, 4, size=P, dtype=np.uint8)
    pool[rng.random(P) < 0.001] = 4
    comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
    read_lens = np.full(n_reads, read_len, dtype=np.int32)
    plant = rng.integers(0, P - Wmax, size=n_reads)
    strand_of = rng.integers(0, 2, size=n_reads)
    reads_mat = np.full((n_reads, Rmax), 255, dtype=np.uint8)
    for i in range(n_reads):
        seg = pool[plant[i] : plant[i] + read_len].copy()
        seg[rng.random(read_len) < 0.01] = rng.integers(0, 4)
        reads_mat[i, :read_len] = comp[seg][::-1] if strand_of[i] else seg
    m = M - n_pad
    aux = np.zeros((4, M), dtype=aux_dtype)
    c_read = rng.integers(0, n_reads, size=m)
    aux[0, :m] = c_read
    near = rng.random(m) < 0.8
    base = np.where(near, plant[c_read] - rng.integers(0, 48, size=m),
                    rng.integers(0, P - Wmax, size=m))
    aux[1, :m] = np.clip(base, 0, P - Wmax)
    aux[2, :m] = rng.integers(read_len + 48, Wmax + 1, size=m)
    aux[3, :m] = np.where(near, strand_of[c_read], rng.integers(0, 2, size=m))
    return pool, reads_mat, read_lens, aux, Wmax


def _exact(name, got, want) -> float:
    """Max |got - want|; raises unless the tensors are identical."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: {bad} of {got.numel()} values differ")
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def phase_kernels(dev, clock):
    """Both kernels against their plain versions (exactly) at every
    shape, and timed beside their bounds: sw_scores at the timing shape
    and at the long-read shape, gather_score_hash at the mapper's pool
    batch, at a small batch (M=1,024) and at the long-read shape."""
    import numpy as np
    import torch

    from vgan_tpu_torch.mapper import sw

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    err = {"sw_scores": 0.0, "gather_score_hash": 0.0}

    def check_sw(label, args):
        got = sw.sw_scores(*args)
        torch.cuda.synchronize()
        err["sw_scores"] = max(err["sw_scores"], _exact(
            f"sw_scores {label}", got, sw.sw_scores_plain(*args)))

    def check_gsh(label, args):
        got = sw.gather_score_hash(*args)
        torch.cuda.synchronize()
        want = sw.gather_score_hash_plain(*args)
        for nm, g, w in zip(("scores", "h1", "h2"), got, want):
            err["gather_score_hash"] = max(err["gather_score_hash"], _exact(
                f"gather_score_hash {label} {nm}", g, w))
        return got

    for seed in range(3):
        check_sw(f"seed {seed}", on_card(*make_batch(
            np.random.default_rng(seed))))
    log("sw_scores: test_sw_pallas sets (B=16, R=64, W=128, seeds 0-2) "
        "equal to plain")

    rng = np.random.default_rng(42)
    B, R, W = MAP_B, MAP_R, MAP_W
    check_sw("mapper shape", on_card(*mapper_shaped_batch(rng, B, R, W)))
    # timing as the JAX bench defines GCUPS: full-length random pairs,
    # B*R*W cells per call
    full = on_card(rng.integers(0, 4, size=(B, R)).astype(np.int32),
                   rng.integers(0, 4, size=(B, W)).astype(np.int32),
                   np.full(B, R, np.int32), np.full(B, W, np.int32))
    check_sw("full-length", full)
    t_sw = clock.timed(f"sw_scores B={B} R={R} W={W}",
                       lambda: sw.sw_scores(*full),
                       lambda: sw.sw_scores_plain(*full), sw_work(*full))
    # long reads: past the 807-row limit of a thread-per-pair kernel
    long_args = on_card(*mapper_shaped_batch(
        rng, LONG_B, LONG_R, LONG_W, L=LONG_READ_LEN))
    check_sw("long reads", long_args)
    t_sw_long = clock.timed(
        f"sw_scores long reads B={LONG_B} R={LONG_R} W={LONG_W}",
        lambda: sw.sw_scores(*long_args),
        lambda: sw.sw_scores_plain(*long_args), sw_work(*long_args),
        plain_reps=1)

    gsh = {}
    for aux_dtype in (np.int32, np.int64):
        pool, reads_mat, read_lens, aux, Wmax = pool_batch(
            np.random.default_rng(7), aux_dtype)
        args = (*on_card(pool, reads_mat, read_lens, aux), Wmax)
        got = check_gsh(f"aux {np.dtype(aux_dtype).name}", args)
        if float(got[0][args[3][2] > 0].max()) < READ_LEN + 2:
            raise AssertionError("gather_score_hash: planted reads not found")
        if aux_dtype is np.int32:
            gsh["pool"] = args
    log("gather_score_hash: 86 MB pool, both strands, padding rows, "
        "int32/int64 aux: scores and hashes equal to plain")
    small = pool_batch(np.random.default_rng(8), np.int32, P=20_000_000,
                       n_reads=1024, n_pad=100, M=1024)
    gsh["small"] = (*on_card(*small[:4]), small[4])
    check_gsh("small batch M=1024", gsh["small"])
    long_pool = pool_batch(np.random.default_rng(9), np.int32,
                           P=20_000_000, n_reads=LONG_B, n_pad=256,
                           M=LONG_B, Rmax=LONG_R, Wmax=LONG_W,
                           read_len=LONG_READ_LEN)
    gsh["long"] = (*on_card(*long_pool[:4]), long_pool[4])
    got = check_gsh(f"long reads Rmax={LONG_R}", gsh["long"])
    if float(got[0].max()) < 0.8 * LONG_READ_LEN:
        raise AssertionError("gather_score_hash: planted long reads not "
                             "found")
    t_gsh = {}
    for key, args in gsh.items():
        M, Rmax, Wmax = args[3].shape[1], args[1].shape[1], args[4]
        t_gsh[key] = clock.timed(
            f"gather_score_hash {key} M={M} Rmax={Rmax} Wmax={Wmax}",
            lambda a=args: sw.gather_score_hash(*a),
            lambda a=args: sw.gather_score_hash_plain(*a), gsh_work(*args),
            plain_reps=1 if key == "long" else 2)
    log("sw_scores and gather_score_hash: equal to plain at every shape, "
        f"R={LONG_R} included")
    return dict(max_abs_err=err, sw=t_sw, sw_long=t_sw_long, gsh=t_gsh)


# ----------------------------------------------------------------- phase 4
def build_world(out_dir):
    """The bench's real-DB world (bench.realdb_graph: N_HAPS haplotypes,
    600 variants, seed 3, over the seeded 16,569-bp backbone) as a DB
    directory, and N_READS reads of haplotype HAP as FASTQ."""
    from vgan_tpu_torch import bench
    from vgan_tpu_torch.graph import synth

    t0 = time.perf_counter()
    graph = bench.realdb_graph(N_HAPS)
    db_dir = os.path.join(out_dir, "db")
    os.makedirs(db_dir)
    graph.save(os.path.join(db_dir, "graph.npz"))
    reads = synth.sample_reads(graph, HAP, N_READS, read_len=READ_LEN,
                               seed=0)
    fq = bench.write_fastq(os.path.join(out_dir, "reads.fq"), reads)
    log(f"world: {graph.n_paths} paths, {graph.n_nodes} nodes, "
        f"{N_READS} reads ({time.perf_counter() - t0:.1f} s)")
    return db_dir, fq


def phase_e2e(dev, out_dir, clock):
    import numpy as np

    from vgan_tpu_torch import cli
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.pipelines import haplocart_device as hd
    from vgan_tpu_torch.pipelines import haplocart_runner as runner
    from vgan_tpu_torch.utils import profiling

    db_dir, fq = build_world(out_dir)
    tsv = os.path.join(out_dir, "hc.tsv")
    profiling.enable()
    runs = []
    # the warm-up run keeps each SW kernel call's and each likelihood
    # step's inputs and outputs
    kernel, calls = sw.gather_score_hash, []
    scorer, hc_calls = hd.score_packed, []

    def keeping(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    def keeping_hc(buf, t, bep, M, S, consensus=False):
        out = scorer(buf, t, bep, M, S, consensus)
        hc_calls.append(((buf, t, bep, M, S, consensus), out))
        return out

    sw.reset_launches()
    hd.reset_launches()
    for i in range(3):  # one warm-up run, two timed
        if os.path.exists(tsv):
            os.remove(tsv)
        profiling.PROFILER.clear()
        sw.gather_score_hash = kernel if i else keeping
        hd.score_packed = scorer if i else keeping_hc
        try:
            t0 = time.perf_counter()
            rc = cli.main(["haplocart", "--db", db_dir, "-fq1", fq, "-o",
                           tsv, "--device", str(dev), "--profile"])
            wall = time.perf_counter() - t0
        finally:
            sw.gather_score_hash = kernel
            hd.score_packed = scorer
        if rc != 0:
            raise AssertionError(f"cli haplocart returned {rc}")
        st = profiling.PROFILER.stages["map+score"]
        mstages = {n: profiling.PROFILER.stages[n].seconds for n in (
            "mapper.submit", "mapper.collect", "mapper.finalize")}
        mstages["chunks"] = profiling.PROFILER.stages["mapper.submit"].calls
        runs.append(dict(wall_s=wall, map_score_s=st.seconds,
                         stages=mstages))
        log(f"cli run {i} ({'warm-up' if i == 0 else 'timed'}): "
            f"{wall:.2f} s wall, map+score {st.seconds:.3f} s = "
            f"{N_READS / st.seconds:.0f} reads/s; mapper stages "
            + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in mstages.items()}))
    launches = dict(sw.LAUNCHES, **hd.LAUNCHES)
    with open(tsv) as f:
        lines = f.read().splitlines()
    if lines[0] != "#sample\tpredicted haplogroup\treads" \
            or lines[1].split("\t")[1] != f"hap{HAP}":
        raise AssertionError(f"unexpected TSV: {lines}")
    if launches["gather_score_hash"] < 1 or launches["hc_node_scores"] < 1:
        raise AssertionError(f"a kernel never launched: {launches}")
    log(f"TSV: {lines[1]}; kernel launches in the 3 runs: {launches}")
    hc_sw = check_sw_calls("haplocart", calls, clock)
    hc_step = check_hc_calls(hc_calls, [r["map_score_s"] for r in runs[1:]],
                             clock.smi)

    # final_vec against the --precise host oracle on the same reads
    db = runner.load_db(db_dir, dev)
    mapper = runner.Mapper(db.graph, k=31, w=11, device=db.device)
    cfg = runner.HaplocartConfig(db_dir=db_dir, fq1=fq, device=str(dev))
    pred, n_dev, vec = runner.run_sample(cfg, db, mapper, fq)
    cfg.precise = True
    opred, n_host, ovec = runner.run_sample(cfg, db, mapper, fq)
    if vec.shape != (N_HAPS,) or not np.isfinite(vec).all():
        raise AssertionError(f"final_vec bad: shape {vec.shape}")
    if int(np.argmax(vec)) != int(np.argmax(ovec)) or pred != opred \
            or n_dev != n_host:
        raise AssertionError(f"device {pred}/{n_dev} vs host oracle "
                             f"{opred}/{n_host}")
    rel = float(np.max(np.abs(vec - ovec) / np.abs(ovec)))
    # f64 sums in another order over ~1e5 terms: far below 1e-9
    if rel > 1e-9:
        raise AssertionError(f"final_vec vs host oracle: rel diff {rel:g}")
    log(f"final_vec: argmax {pred} = host oracle's; {n_dev} reads kept; "
        f"max rel diff {rel:.3g}")
    obj = check_object_path(dev, db.graph, fq, clock)
    timed_runs = runs[1:]
    return dict(launches=launches, runs=runs, sw=hc_sw, object_path=obj,
                hc_step=hc_step,
                reads_per_s=[N_READS / r["map_score_s"] for r in timed_runs],
                cli_wall_s=[r["wall_s"] for r in timed_runs],
                world=dict(db=db, mapper=mapper, db_dir=db_dir, fq=fq))


def hc_bound_ms(buf, views, t, consensus):
    """f64_bound_ms of one node_scores call on packed views: the positions
    that count (valid, both codes bases) at HC_F64_OPS_PER_POSITION and
    every row at HC_F64_OPS_PER_ROW, against the bytes moved once: the
    buffer, each table the call reads (match_tab; without consensus also
    mapp_tab, imtab and bg, and qtab where a row without use_bep has a
    position that counts) and c and sum(b) written."""
    import torch

    M, S = views.g.shape
    col = torch.arange(S, device=buf.device)
    counts = ((col[None, :] < views.take[:, None].long())
              & (views.g < 4) & (views.r < 4))
    n_pos = int(counts.sum())
    tables = [t.match_tab]
    if not consensus:
        tables += [t.mapp_tab, t.imtab, t.bg]
        if bool(counts[views.use_bep == 0].any()):
            tables.append(t.qtab)
    ops = HC_F64_OPS_PER_POSITION * n_pos + HC_F64_OPS_PER_ROW * M
    return f64_bound_ms(ops, buf.numel() + nbytes(*tables)
                        + 8 * (t.support.shape[0] + 1))


def _close_to_node_sums(label, c, pc, views, t, bep, consensus, rtol):
    """Raises unless c is within rtol of the sum of |A - b| over each
    node's rows of pc (equal where pc is not finite): the f64 atomics add
    a node's rows in another order each run, and a node whose rows
    differ in sign cancels. Returns the largest absolute difference."""
    import torch

    from vgan_tpu_torch.pipelines import haplocart_device as hd

    plain = hd.packed_batch(views, consensus)
    d = hd.mapping_scores(plain, t, bep, consensus) - plain.b
    node = plain.node.long()
    keep = (node >= 0) & (node < pc.shape[0])
    mag = torch.zeros_like(pc).index_add_(0, node[keep], d[keep].abs())
    fin = torch.isfinite(pc)
    err = (c - pc).abs()[fin]
    if (not torch.equal(fin, torch.isfinite(c))
            or not torch.equal(c[~fin], pc[~fin])
            or not bool((err <= rtol * mag[fin]).all())):
        raise AssertionError(f"{label}: not within {rtol:g} of each node's "
                             f"sum of |A - b|")
    return float(err.max()) if err.numel() else 0.0


HC_PHASES = ("issue of the next tile's loads",
             "table gathers (with the wait for the row's loads)",
             "the S terms", "the atomic add")


def hc_phase_split(views, t, bep, consensus, reps=5):
    """node_scores through the measurement build (-DVGAN_HC_PHASE_CLOCKS,
    _native.haplocart_clocks_lib): the main kernel's cycles in each phase
    (HC_PHASES), summed over rows and `reps` calls: (shares, cycles a
    row)."""
    import ctypes

    import torch

    from vgan_tpu_torch import _native
    from vgan_tpu_torch.pipelines import haplocart_device as hd

    lib, kept = _native.haplocart_clocks_lib(), _native.haplocart_lib()
    cycles = (ctypes.c_ulonglong * 4)()
    _native._loaded["haplocart"] = lib
    try:
        hd.node_scores(views, t, bep, consensus)
        torch.cuda.synchronize()
        lib.hc_phase_clocks(cycles)  # clears the warm-up call's
        for _ in range(reps):
            hd.node_scores(views, t, bep, consensus)
        torch.cuda.synchronize()
        if lib.hc_phase_clocks(cycles) != 0:
            raise RuntimeError("hc_phase_clocks failed")
    finally:
        _native._loaded["haplocart"] = kept
    total = sum(cycles) or 1
    rows = reps * int((views.take > 0).sum()) or 1
    return ([x / total for x in cycles], [x / rows for x in cycles])


def check_hc_calls(calls, map_score_s, smi):
    """Each score_packed call of a HaploCart run (`calls`: its arguments
    and final_vec): node_scores, one hc_node_scores_kernel launch on the
    buffer's views, against node_scores_plain on the card (c to 1e-12 of
    each node's sum of |A - b|, _close_to_node_sums; sum(b) to rtol
    1e-12), and the call's final_vec against the plain chain's plus the
    GEMV, rtol 1e-12. Each
    timed by CUDA events beside its bound: the kernel (and on the device
    alone, queued), the plain chain (the production path before the
    kernel), the GEMV, and the whole call. Logs the calls' sum as a share
    of the timed runs' map+score."""
    from vgan_tpu_torch.pipelines import haplocart_device as hd

    if not calls:
        raise AssertionError("the HaploCart run made no score_packed call")
    rows, max_err, whole_ms = [], 0.0, 0.0
    for i, ((buf, t, bep, M, S, cons), out) in enumerate(calls):
        views = hd.unpack(buf, M, S, t.support.dtype)
        c, total_b = hd.node_scores(views, t, bep, cons)
        pc, pb = hd.node_scores_plain(views, t, bep, cons)
        label = f"haplocart likelihood step call {i} M={M} S={S}"
        max_err = max(max_err,
                      _close_to_node_sums(f"{label} c", c, pc, views, t,
                                          bep, cons, 1e-12),
                      _close(f"{label} sum(b)", total_b, pb, 1e-12))
        _close(f"{label} final_vec", out, pb + pc @ t.support, 1e-12)
        step = dict(
            ms=cuda_ms(lambda: hd.node_scores(views, t, bep, cons), reps=50),
            device_ms=queued_ms(lambda: hd.node_scores(views, t, bep, cons),
                                50),
            plain_ms=cuda_ms(lambda: hd.node_scores_plain(views, t, bep,
                                                          cons), reps=5),
            gemv_ms=cuda_ms(lambda: total_b + c @ t.support, reps=20),
            call_ms=cuda_ms(lambda: hd.score_packed(buf, t, bep, M, S, cons),
                            reps=20))
        step["bound_ms"], step["bound_by"] = hc_bound_ms(buf, views, t,
                                                         cons)
        step["phase_share"], step["phase_cycles_a_row"] = hc_phase_split(
            views, t, bep, cons)
        whole_ms += step["call_ms"]
        dev_txt = ("not measured" if step["device_ms"] is None
                   else f"{step['device_ms']:.4f} ms")
        log(f"{label} ({int((views.take > 0).sum())} live rows): kernel "
            f"{step['ms']:.4f} ms ({100 * step['bound_ms'] / step['ms']:.1f}"
            f" % of the {step['bound_ms']:.5f} ms bound, {step['bound_by']};"
            f" on the device alone {dev_txt}), plain chain "
            f"{step['plain_ms']:.4f} ms, GEMV {step['gemv_ms']:.4f} ms, the "
            f"whole call {step['call_ms']:.4f} ms; on {smi}")
        log(f"{label} phase split (clock64 in a measurement build, cycles "
            f"summed over live rows): " + "; ".join(
                f"{name} {100 * sh:.1f} % ({cyc:.0f} a row)"
                for name, sh, cyc in zip(HC_PHASES, step["phase_share"],
                                         step["phase_cycles_a_row"]))
            + f"; on {smi}")
        step.update(M=M, S=S)
        rows.append(step)
    share = [whole_ms / 1e3 / s for s in map_score_s]
    log(f"haplocart likelihood step: {len(calls)} calls a run, "
        f"{whole_ms:.3f} ms together = "
        + ", ".join(f"{100 * x:.3f}" for x in share)
        + f" % of the timed runs' map+score; kernel equal to plain (max abs "
        f"err {max_err:.3g}); on {smi}")
    return dict(max_abs_err=max_err, calls=rows, calls_a_run=len(calls),
                sum_ms=whole_ms, share_of_map_score=share)


def check_object_path(dev, graph, fq, clock):
    """The mapper's object path (BatchedMapper._map_reads_obj: the
    oracle the production path is held against; its candidate windows
    are scored by one sw_scores call) on the first OBJECT_PATH_READS
    reads, with the launch counts set to 0 just before it: sw_scores
    launched, every alignment equal to the production path's, each
    sw_scores call equal to plain and timed beside its bound."""
    from vgan_tpu_torch.io import fastx
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.mapper.giraffe import BatchedMapper

    reads = fastx.read_fastq(fq)[:OBJECT_PATH_READS]
    mapper = BatchedMapper(graph, k=31, w=11, device=dev)
    kernel, calls = sw.sw_scores, []

    def keeping(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    sw.reset_launches()
    sw.sw_scores = keeping
    try:
        t0 = time.perf_counter()
        old = mapper._map_reads_obj(reads)
        obj_s = time.perf_counter() - t0
    finally:
        sw.sw_scores = kernel
    launches = sw.LAUNCHES["sw_scores"]
    if launches < 1:
        raise AssertionError("object path launched no sw_scores kernel")
    new = mapper.map_reads(reads)

    def key(a):
        return (a.score, a.mapping_quality, round(a.identity, 12),
                [(m.position.node_id, m.position.offset,
                  m.position.is_reverse,
                  [(e.from_length, e.to_length, e.sequence)
                   for e in m.edits]) for m in a.path.mappings])

    bad = [a.name for a, b in zip(old, new) if key(a) != key(b)]
    if bad or len(old) != len(new):
        raise AssertionError(f"object path vs production path: {len(bad)} "
                             f"alignments differ, e.g. {bad[:3]}")
    max_err, rows = 0.0, []
    for i, (args, got) in enumerate(calls):
        max_err = max(max_err, _exact(f"object path sw_scores call {i}",
                                      got, sw.sw_scores_plain(*args)))
        B, R = args[0].shape
        W = args[1].shape[1]
        t = clock.timed(
            f"object path sw_scores call {i} B={B} R={R} W={W}",
            lambda a=args: sw.sw_scores(*a),
            lambda a=args: sw.sw_scores_plain(*a), sw_work(*args))
        t.update(B=B, R=R, W=W)
        rows.append(t)
    log(f"object path: {len(reads)} reads in {obj_s:.2f} s, {launches} "
        f"sw_scores launch(es), alignments equal to the production "
        f"path's, calls equal to plain")
    return dict(launches=launches, max_abs_err=max_err, calls=rows,
                map_s=obj_s)


# ----------------------------------------------------------------- phase 5
def build_euka_world(out_dir):
    """The euka DB and read mixture (see the module docstring), through
    tests/_torch_world.py's functions over the port's synth."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _torch_world as world
    from vgan_tpu_torch.graph import synth
    from vgan_tpu_torch.graph.packed import PackedGraph

    n_taxa, mix = EUKA_TAXA, EUKA_MIX
    t0 = time.perf_counter()
    graph, ranges = world.build_euka_graph(
        synth, PackedGraph, n_taxa=n_taxa, n_bp=EUKA_BP, n_haps=EUKA_HAPS,
        n_variants=EUKA_VARIANTS, seed=11)
    chunks = world.euka_bins(ranges, n_bins=EUKA_BINS, whole_bin=True)
    euka_dir, d5, d3 = world.write_euka_db(
        os.path.join(out_dir, "euka"), graph, ranges, EUKA_HAPS,
        [0.03] * n_taxa, chunks)
    fq = os.path.join(out_dir, "euka_reads.fq")
    n_reads = len(world.write_mixture_fastq(
        synth, graph, fq, [(t, n) for t, n, _w in mix], EUKA_HAPS,
        read_len=EUKA_READ_LEN))
    log(f"euka world: {n_taxa} taxa, {graph.n_paths} paths, "
        f"{graph.n_nodes} nodes, {len(graph.node_seq_pool)} bp of node "
        f"sequence, {n_reads} reads ({time.perf_counter() - t0:.1f} s)")
    return euka_dir, d5, d3, fq, n_reads


def check_euka_outputs(prefix):
    """The planted taxa and nothing else detected, their medians in
    their windows, and every output file written."""
    with open(prefix + "_detected.tsv") as f:
        rows = [l.split("\t") for l in f.read().splitlines()[1:]]
    got = {r[0]: float(r[3]) for r in rows}
    want = {f"Taxon{t}": w for t, _n, w in EUKA_MIX}
    if sorted(got) != sorted(want):
        raise AssertionError(f"euka detected {sorted(got)}, planted "
                             f"{sorted(want)}")
    for name, (lo, hi) in want.items():
        if not lo <= got[name] <= hi:
            raise AssertionError(f"euka {name} median {got[name]} outside "
                                 f"[{lo}, {hi}]")
    files = [prefix + s for s in ("_abundance.tsv", "_detected.tsv",
                                  "_coverage.tsv", "_inSize.tsv", "_5p.prof",
                                  "_3p.prof")]
    files += [f"{prefix}_{name}.prof" for name in want]
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise AssertionError(f"euka outputs missing: {missing}")
    return got


def profile_call(fn):
    """fn() under torch.profiler: device busy time (the sum of the
    device's kernel, copy and memset time), its share of the wall time,
    the six device ops that took longest, and the peak device memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ops = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU or getattr(
                e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ops.append((us, e.count, e.key))
    busy = sum(us for us, _n, _k in ops) / 1e6
    ops.sort(reverse=True)
    return dict(wall_s=wall, device_busy_s=busy,
                idle_share=(1.0 - busy / wall) if busy else None,
                peak_mib=peak / 2**20,
                top_ops=[[k[:80], round(us / 1e3, 3), n]
                         for us, n, k in ops[:6]])


def check_sw_calls(label, calls, clock):
    """Each gather_score_hash call of a mapping (the pipeline's own read,
    window and row buckets) against the plain version on the same
    inputs, exactly, and timed beside its bound."""
    from vgan_tpu_torch.mapper import sw

    max_err, rows = 0.0, []
    for i, (args, got) in enumerate(calls):
        want = sw.gather_score_hash_plain(*args)
        for nm, g, w in zip(("scores", "h1", "h2"), got, want):
            max_err = max(max_err, _exact(
                f"{label} gather_score_hash call {i} {nm}", g, w))
        M, Rmax, Wmax = args[3].shape[1], args[1].shape[1], args[4]
        live = int((args[3][2] > 0).sum())
        t = clock.timed(
            f"{label} gather_score_hash call {i} M={M} ({live} live) "
            f"Rmax={Rmax} Wmax={Wmax}",
            lambda a=args: sw.gather_score_hash(*a),
            lambda a=args: sw.gather_score_hash_plain(*a), gsh_work(*args))
        t.update(M=M, Rmax=Rmax, Wmax=Wmax, live_rows=live)
        rows.append(t)
    log(f"{label}: {len(calls)} gather_score_hash calls, scores and "
        f"hashes equal to plain")
    return dict(max_abs_err=max_err, calls=rows)


def compare_card_cpu(dev, euka_dir, d5, d3, fq, clock):
    """Map on the card and on the CPU: every field of the two tables
    equal, and each SW kernel call of the card's mapping equal to the
    plain version. Then score the card's table and run the MCMC on the
    card and on the CPU: il/nl and the trace to rtol 1e-12; counts and
    detected taxa equal."""
    import numpy as np
    import torch

    from vgan_tpu_torch.graph.packed import PackedGraph
    from vgan_tpu_torch.io import fastx
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.mapper.giraffe import BatchedMapper
    from vgan_tpu_torch.models.damage import DamageModel
    from vgan_tpu_torch.pipelines import euka as ek
    from vgan_tpu_torch.pipelines.euka_runner import (
        abundance_mcmc_from_result)

    prefix = os.path.join(euka_dir, "euka_db")
    clades = ek.load_clade_info(prefix + ".clade")
    chunks = ek.load_clade_chunks(prefix + ".bins")
    graph = PackedGraph.load(prefix + ".npz")
    reads = fastx.read_fastq(fq)
    mapper = BatchedMapper(graph, k=20, w=10, device=dev)
    # the first mapping of a freshly loaded graph builds its lazy caches
    # (the oriented adjacency among them), as every CLI run does; the
    # second finds them built, and keeps each SW call's inputs and output
    kernel, calls = sw.gather_score_hash, []

    def keeping(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    map_s = []
    for i in range(2):
        sw.gather_score_hash = keeping if i else kernel
        try:
            t0 = time.perf_counter()
            table = mapper.map_reads_table(reads)
            map_s.append(time.perf_counter() - t0)
        finally:
            sw.gather_score_hash = kernel
    torch.cuda.synchronize()
    sw_check = check_sw_calls("euka", calls, clock)
    t0 = time.perf_counter()
    on_cpu = BatchedMapper(graph, k=20, w=10, device="cpu").map_reads_table(
        reads)
    map_cpu_s = time.perf_counter() - t0
    for f in ("score", "identity", "mq", "nmap", "m_node", "m_off", "e_from",
              "e_to"):
        if not np.array_equal(getattr(table, f), getattr(on_cpu, f)):
            raise AssertionError(f"euka mapping card vs cpu: {f} differs")
    if table.eseq != on_cpu.eseq:
        raise AssertionError("euka mapping card vs cpu: eseq differs")
    log(f"euka mapping: the card's table equals the CPU's field for field "
        f"({table.n} reads; cpu {map_cpu_s:.2f} s)")
    dm = DamageModel.from_profiles(d5, d3)
    out = {}
    for d in (dev, "cpu"):
        sc = ek.EukaScorer(graph, clades, chunks, damage=dm, device=d)
        seen = []
        score_arrays = sc._score_arrays

        def recording(*arrays, _f=score_arrays, _seen=seen):
            il_nl = _f(*arrays)
            _seen.append(il_nl)
            return il_nl

        sc._score_arrays = recording
        res = sc.score_table(table)
        out[str(d)] = (res, np.concatenate([x[0] for x in seen]),
                       np.concatenate([x[1] for x in seen]))
    (rc, ilc, nlc), (rh, ilh, nlh) = out[str(dev)], out["cpu"]
    errs = [float(np.max(np.abs(a - b) / np.abs(b)))
            for a, b in ((ilc, ilh), (nlc, nlh))]
    if max(errs) > 1e-12:
        raise AssertionError(f"euka scorer card vs cpu: rel err {errs}")
    if not np.array_equal(rc.counts, rh.counts) or rc.detected != rh.detected:
        raise AssertionError("euka scorer card vs cpu: counts/detected differ")
    det = rc.detected
    kw = dict(n_iter=EUKA_ITER, burnin=EUKA_BURNIN)
    t0 = time.perf_counter()
    mc = abundance_mcmc_from_result(rc, device=dev, **kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mh = abundance_mcmc_from_result(rc, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    trace_err = float(np.max(np.abs(mc.samples - mh.samples) / mh.samples))
    if trace_err > 1e-12 or mc.samples.shape != (EUKA_STEPS, len(det)):
        raise AssertionError(f"MCMC card vs cpu: rel err {trace_err}, "
                             f"shape {mc.samples.shape}")
    log(f"mapping {table.n} reads on the card with a fresh graph "
        f"{map_s[0]:.3f} s, again with its caches built {map_s[1]:.3f} s")
    log(f"card vs cpu: {table.n} reads, il/nl max rel err {errs[0]:.3g} / "
        f"{errs[1]:.3g}, counts and detected {det} equal; MCMC trace "
        f"{mc.samples.shape} max rel err {trace_err:.3g} (card "
        f"{card_s:.2f} s, cpu {cpu_s:.2f} s)")
    return dict(il_nl_rel_err=max(errs), mcmc_rel_err=trace_err,
                mcmc_card_s=card_s, mcmc_cpu_s=cpu_s, map_cold_s=map_s[0],
                map_warm_s=map_s[1], map_cpu_s=map_cpu_s,
                sw=sw_check), rc


def same_accepts(label, args, props, plain_props):
    """The steps the kernel's and the plain version's proposals accepted
    (replayed, accepted_steps) must be the same; raises at the first that
    differs, with |log u - (ll - cll)| there. Returns (steps, smallest
    margin)."""
    from vgan_tpu_torch.infer import abundance_mcmc as am

    current, cur_ll, z, u, alpha, n_reads, const_ll = args
    ks, km = am.accepted_steps(props, u, n_reads, const_ll, cur_ll)
    ps, _pm = am.accepted_steps(plain_props, u, n_reads, const_ll, cur_ll)
    if ks != ps:
        s = min(set(ks) ^ set(ps))  # the first step decided otherwise
        raise AssertionError(f"{label}: the kernel and the plain version "
                             f"decide step {s} otherwise (|log u - (ll - "
                             f"cll)| there {km[s]:.3g})")
    return ks, float(km.min()) if len(km) else 0.0


def synthetic_chain(dev, T, S, seed, high=False):
    """run_segment's arguments of a chain over T taxa from START_LL:
    hundreds to thousands of reads a taxon from the posterior's mode (few
    steps accept), or with `high` 4 / 3 / 2 reads (T = 3) from a uniform
    start (most do); noise from draw_noise(S, T, seed)."""
    import numpy as np
    import torch

    from vgan_tpu_torch.infer import abundance_mcmc as am

    if high:
        n, init, const = np.array([4.0, 3.0, 2.0]), np.full(3, 1 / 3), -5.0
    else:
        n = np.random.default_rng(T).integers(100, 2000, size=T).astype(
            np.float64)
        init, const = n / n.sum(), -5.0 * T
    z, u = am.draw_noise(S, len(n), seed)

    def f(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    return (f(init), f(am.START_LL), z.to(dev), u.to(dev), 0.1, f(n),
            f(const))


def window_sweep(chains, smi):
    """Each chain (label: run_segment's arguments) at every window the
    kernel can take (1..8 consumer warps): its outputs bit-equal at every
    window, timed a step and a round (CUDA events, 3 launches)."""
    import torch

    from vgan_tpu_torch.infer import abundance_mcmc as am

    out = {}
    for label, args in chains.items():
        S, T = args[2].shape
        (s0, l0), p0 = am.run_segment(*args)
        steps = am.accepted_steps(p0, args[3], args[5], args[6], args[1])[0]
        rows = []
        for w in range(1, 9):
            (sw, lw), pw = am.run_segment(*args, warps=w)
            if not (torch.equal(pw, p0) and torch.equal(sw, s0)
                    and torch.equal(lw, l0)):
                raise AssertionError(f"window sweep {label}: {w} warps "
                                     "give other bits")
            d = am.window(T, w)
            ms = cuda_ms(lambda: am.run_segment(*args, warps=w), reps=3)
            rounds = am.window_rounds(steps, S, d)
            rows.append(dict(warps=w, d=d, rounds=rounds,
                             us_a_step=1e3 * ms / S,
                             us_a_round=1e3 * ms / rounds))
        out[label] = dict(T=T, S=S, acceptance=len(steps) / S,
                          default_d=am.window(T), by_warps=rows)
        log(f"abundance chain window sweep, {label} (T={T}, S={S}, "
            f"acceptance {len(steps) / S:.4f}, default window "
            f"{am.window(T)}): " + "; ".join(
                f"d={r['d']} {r['us_a_step']:.4f} us a step "
                f"({r['rounds']} rounds, {r['us_a_round']:.3f} us a round)"
                for r in rows) + f"; bit-equal at every window; on {smi}")
    return out


def check_chain_kernel(args, smi):
    """abundance_mcmc_segment_kernel against run_segment_plain on the card
    over a CLI run's own segment (`args`: run_segment's arguments there):
    proposals, state and likelihood to rtol 1e-12, and the same accepted
    steps (same_accepts). Timed by CUDA events: the kernel a step beside
    its bound, its acceptance and the rounds of its window, the serial
    floor (the same steps at T = 1, where every step accepts), the plain
    version once, and as the library's comparator one CUDA-graph capture
    of the plain version's torch ops over the same steps, replayed (its
    proposals checked; never on the path). Then a high-acceptance chain
    of the same shape (synthetic_chain) against the plain version and
    timed, and window_sweep over the floor, the segment and synthetic
    chains at T = 16 and 334."""
    import torch

    from vgan_tpu_torch.infer import abundance_mcmc as am

    current, cur_ll, z, u, alpha, n_reads, const_ll = args
    S, T = z.shape
    (ks, kl), kp = am.run_segment(*args)
    (ps, pl), pp = am.run_segment_plain(*args)
    max_err = max(_close("chain kernel proposals", kp, pp, 1e-12),
                  _close("chain kernel state", ks, ps, 1e-12),
                  _close("chain kernel likelihood", kl, pl, 1e-12))
    steps, margin = same_accepts("chain kernel", args, kp, pp)
    d = am.window(T)
    rounds = am.window_rounds(steps, S, d)
    ms = cuda_ms(lambda: am.run_segment(*args), reps=5)
    floor = (torch.ones(1, dtype=current.dtype, device=current.device),
             cur_ll, z[:, :1].contiguous(), u, alpha, n_reads[:1], const_ll)
    floor_ms = cuda_ms(lambda: am.run_segment(*floor), reps=5)
    plain_ms = cuda_ms(lambda: am.run_segment_plain(*args), reps=1,
                       warmup=0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        (_gs, _gl), gp = am.run_segment_plain(*args)
    capture_s = time.perf_counter() - t0
    graph_ms = cuda_ms(graph.replay, reps=2)
    _close("chain CUDA graph replay proposals", gp, pp, 1e-12)
    del graph
    bms, by = f64_bound_ms(S * (AM_F64_OPS_PER_TAXON * T
                                + AM_F64_OPS_PER_STEP), 2 * S * T * 8)
    log(f"abundance chain kernel, the CLI run's segment (T={T}, S={S}): "
        f"{ms:.3f} ms = {1e3 * ms / S:.4f} us a step ({100 * bms / ms:.3f} "
        f"% of the {bms:.5f} ms bound, {by}); acceptance {len(steps) / S:.4f}"
        f" ({len(steps)} steps, the same as plain's; smallest |log u - "
        f"(ll - cll)| {margin:.3g}), window {d}: {rounds} rounds, "
        f"{S / rounds:.2f} steps a round, {1e3 * ms / rounds:.3f} us a "
        f"round; serial floor (T = 1) {1e3 * floor_ms / S:.4f} us a step; "
        f"plain version {plain_ms:.1f} ms; its ops as one CUDA graph "
        f"{graph_ms:.1f} ms a replay (captured in {capture_s:.1f} s); equal "
        f"to plain (max abs err {max_err:.3g}); on {smi}")
    high = synthetic_chain(current.device, 3, S, seed=3, high=True)
    (hs, hl), hp = am.run_segment(*high)
    (hps, hpl), hpp = am.run_segment_plain(*high)
    max_err = max(max_err,
                  _close("chain kernel, high acceptance", hp, hpp, 1e-12),
                  _close("chain kernel, high acceptance: state", hs, hps,
                         1e-12),
                  _close("chain kernel, high acceptance: likelihood", hl,
                         hpl, 1e-12))
    hsteps, _hm = same_accepts("chain kernel, high acceptance", high, hp,
                               hpp)
    high_ms = cuda_ms(lambda: am.run_segment(*high), reps=5)
    hrounds = am.window_rounds(hsteps, S, d)
    log(f"abundance chain kernel, high acceptance (4 / 3 / 2 reads, T=3, "
        f"S={S}): {1e3 * high_ms / S:.4f} us a step; acceptance "
        f"{len(hsteps) / S:.4f}, {S / hrounds:.2f} steps a round; equal to "
        f"plain with the same accepted steps; on {smi}")
    sweep = window_sweep({
        "T = 1 (the floor)": floor, "the CLI run's segment": args,
        "T = 16": synthetic_chain(current.device, 16, S, seed=16),
        "T = 334": synthetic_chain(current.device, 334, S, seed=334)}, smi)
    return dict(T=T, S=S, ms=ms, us_a_step=1e3 * ms / S, floor_ms=floor_ms,
                plain_ms=plain_ms, graph_ms=graph_ms, capture_s=capture_s,
                bound_ms=bms, bound_by=by, max_abs_err=max_err, window=d,
                acceptance=len(steps) / S, steps_a_round=S / rounds,
                smallest_margin=margin,
                high=dict(us_a_step=1e3 * high_ms / S,
                          acceptance=len(hsteps) / S,
                          steps_a_round=S / hrounds),
                sweep=sweep)


def euka_work(args):
    """(f64 instructions, bytes, valid columns by class) of one
    score_batch call on `args` (its 12 arguments): each valid column's
    instructions by its class (EUKA_OPS_*, this call's data) and a row's;
    every argument read once and the two [B] outputs written once."""
    import torch

    g, r, _q, _n, _L, _pd, valid = args[:7]
    is_n = (g == 4) | (r == 4)
    is_gap = ~is_n & ((g == 5) | (r == 5))
    is_rare = ~is_n & ~is_gap & ((g == 7) | (r == 7))
    is_soft = ~is_n & ~is_gap & ~is_rare & ((g == 6) | (r == 6))
    third = is_soft & (torch.cumsum(is_soft.to(torch.int32), 1) % 3 == 0)
    acgt = ~(is_n | is_gap | is_rare | is_soft)
    cols = {k: int((m & valid).sum()) for k, m in (
        ("acgt", acgt), ("soft_third", third), ("soft_other", is_soft & ~third),
        ("n_gap_rare", is_n | is_gap | is_rare))}
    ops = (cols["acgt"] * EUKA_OPS_ACGT + cols["soft_third"]
           * EUKA_OPS_SOFT_THIRD + cols["soft_other"] * EUKA_OPS_SOFT_OTHER
           + cols["n_gap_rare"] * EUKA_OPS_OTHER + g.shape[0] * EUKA_OPS_ROW)
    return ops, nbytes(*args) + 2 * 8 * g.shape[0], cols


def synthetic_euka_args(tables, B, L, seed=5):
    """score_batch's arguments for B aligned reads of 924..1,024 columns
    in an L-column bucket on the tables' device: ACGT with 2 %
    substitutions, 0.5 % N and 0.5 % gaps, softclips at both ends of a
    quarter of the reads, qualities 20..40, damage positions along the
    read, pair distance 0.03; `tables`: (sub5p, sub3p, qtab, bfreq,
    ttr)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lens = rng.integers(L - 100, L + 1, size=B)
    g = rng.integers(0, 4, size=(B, L))
    r = np.where(rng.random((B, L)) < 0.98, g, rng.integers(0, 4, (B, L)))
    r[rng.random((B, L)) < 0.005] = 4
    g[rng.random((B, L)) < 0.005] = 5
    clip = rng.random(B) < 0.25
    g[clip, :12] = 6
    g[clip[:, None] & (np.arange(L)[None, :] >= lens[:, None] - 9)] = 6
    valid = np.arange(L)[None, :] < lens[:, None]
    n_pos = np.where(valid, np.arange(L)[None, :], 0)
    dev = tables[0].device

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    i32 = torch.int32
    return (t(g, i32), t(r, i32), t(rng.integers(20, 41, (B, L)), i32),
            t(n_pos, i32), t(lens, i32), t(np.full(B, 0.03), torch.float64),
            t(valid, torch.bool)) + tuple(tables)


def both_orientations(args, seed=4):
    """score_batch's arguments `args` with every other read, drawn from a
    seed, reverse: n_pos = L_read - 1 - the forward position inside the
    read, as euka counts a reverse read's damage positions down."""
    import torch

    n_pos, L_read, valid = args[3], args[4], args[6]
    gen = torch.Generator(device=n_pos.device).manual_seed(seed)
    rev = torch.rand(n_pos.shape[0], generator=gen, device=n_pos.device) < 0.5
    back = torch.where(valid, L_read[:, None] - 1 - n_pos, n_pos)
    n_pos = torch.where(rev[:, None], back, n_pos).to(torch.int32)
    return args[:3] + (n_pos.contiguous(),) + args[4:]


def time_euka_call(label, args, got, smi):
    """One score_batch call (`got`: the kernel's outputs on `args`)
    against score_batch_plain on the card (rtol 1e-12, NaN where NaN);
    timed by CUDA events and on the device alone, beside its bound
    (f64_bound_ms of euka_work), the plain version and, as the library's
    comparator, one CUDA-graph capture of the plain version's torch ops
    replayed (its outputs checked; never on the path)."""
    import torch

    from vgan_tpu_torch.pipelines import euka as ek

    want = ek.score_batch_plain(*args)
    err = max(_close(f"{label} il", got[0], want[0], 1e-12),
              _close(f"{label} nl", got[1], want[1], 1e-12))
    ms = cuda_ms(lambda: ek.score_batch(*args), reps=20)
    dev_ms = queued_ms(lambda: ek.score_batch(*args), 20)
    plain = cuda_ms(lambda: ek.score_batch_plain(*args), reps=5)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_il, g_nl = ek.score_batch_plain(*args)
    graph_ms = cuda_ms(graph.replay, reps=10)
    _close(f"{label} CUDA graph replay il", g_il, want[0], 1e-12)
    _close(f"{label} CUDA graph replay nl", g_nl, want[1], 1e-12)
    del graph
    ops, moved, cols = euka_work(args)
    bms, by = f64_bound_ms(ops, moved)
    B, L = args[0].shape
    dev_txt = ("device time not measured" if dev_ms is None else
               f"on the device alone {dev_ms:.4f} ms = "
               f"{100 * bms / dev_ms:.1f} %")
    cfg = euka_config(B, L)
    split = euka_phase_split(args)
    log(f"{label} (B={B}, L={L}, valid columns {cols}): kernel {ms:.4f} ms "
        f"a call ({100 * bms / ms:.2f} % of the {bms:.5f} ms bound, {by}; "
        f"{dev_txt}), plain {plain:.3f} ms, its ops as one CUDA graph "
        f"{graph_ms:.3f} ms a replay; equal to plain (max abs err "
        f"{err:.3g}); launch "
        f"{json.dumps(cfg)}; clock64 phase split (measurement build) "
        f"{json.dumps(split)}; on {smi}")
    return dict(B=B, L=L, ms=ms, device_ms=dev_ms, plain_ms=plain,
                graph_ms=graph_ms, bound_ms=bms, bound_by=by,
                max_abs_err=err, columns=cols,
                config=cfg, phase_split=split)


# euka_score_kernel's clock64 phases (csrc/euka.cu g_euka_clocks): a CTA's,
# then an item's of a warp
EUKA_CTA_PHASES = ("codes_and_range", "range_reduce", "staging", "items",
                   "cluster_wait")
EUKA_ITEM_PHASES = ("codes_wait_and_classes", "tables_math_logs",
                    "row_sum_and_next_loads")


def euka_phase_split(args, reps=10):
    """Mean cycles a CTA and a warp's item in each phase of
    euka_score_kernel on `args`, from the measurement build
    (_native.euka_clocks_lib, -DVGAN_EUKA_PHASE_CLOCKS) called through
    score_batch `reps` times; and the shares of CTAs that staged their
    table rows, and that staged them in two rounds."""
    import ctypes

    import torch

    from vgan_tpu_torch import _native
    from vgan_tpu_torch.pipelines import euka as ek

    lib, ours = _native.euka_clocks_lib(), _native.euka_lib()
    out = (ctypes.c_ulonglong * 20)()
    _native._loaded["euka"] = lib
    try:
        torch.cuda.synchronize()
        lib.euka_phase_clocks(out)  # clear
        for _ in range(reps):
            ek.score_batch(*args)
        torch.cuda.synchronize()
        if lib.euka_phase_clocks(out) != 0:
            raise AssertionError("euka_phase_clocks failed")
    finally:
        _native._loaded["euka"] = ours
    v = list(out)
    ctas, items = max(v[8], 1), max(v[9], 1)
    nc = euka_config(args[0].shape[0], args[0].shape[1])["nc"]
    return dict(cta_cycles={k: round(v[i] / ctas)
                            for i, k in enumerate(EUKA_CTA_PHASES)},
                item_cycles={k: round(v[5 + i] / items)
                             for i, k in enumerate(EUKA_ITEM_PHASES)},
                items_cycles_by_rank=[round(v[11 + k] * nc / ctas)
                                      for k in range(nc)],
                staged_share=v[10] / ctas, two_round_share=v[19] / ctas)


def euka_config(B, L):
    """euka_score_kernel's launch for B rows of L columns and its
    occupancy on this card (csrc/euka.cu euka_score_config)."""
    import ctypes

    from vgan_tpu_torch import _native

    out = (ctypes.c_int * 11)()
    rc = _native.euka_lib().euka_score_config(B, L, out)
    if rc != 0:
        raise AssertionError(f"euka_score_config: CUDA error {rc}")
    return dict(zip(("G", "nc", "S", "P", "rows_a_cta", "ctas",
                     "ctas_an_sm", "registers", "spill_bytes",
                     "shared_bytes", "staged_rows"), list(out)))


def check_euka_scorer(calls, map_score_s, smi):
    """Each score_batch call of the euka warm-up run (`calls`: its
    arguments and outputs) held to score_batch_plain and timed
    (time_euka_call), the calls' kernel time as a share of the run's
    map+score; then the synthetic 1,000-bp batch (synthetic_euka_args on
    the run's own tables) the same way, and the same batch with half of
    its reads reverse (both_orientations)."""
    from vgan_tpu_torch.pipelines import euka as ek

    if not calls:
        raise AssertionError("the euka warm-up run made no scorer call")
    rows = [time_euka_call(f"euka scorer call {i}", args, got, smi)
            for i, (args, got) in enumerate(calls)]
    total = sum(r["ms"] for r in rows)
    log(f"euka scorer: {len(rows)} calls in the warm-up run, {total:.4f} ms "
        f"together = {100 * total / 1e3 / map_score_s:.4f} % of its "
        f"map+score ({map_score_s:.3f} s); on {smi}")
    args = synthetic_euka_args(calls[0][0][7:], EUKA_LONG_B, EUKA_LONG_L)
    long = time_euka_call("euka scorer, synthetic 1,000-bp reads", args,
                          ek.score_batch(*args), smi)
    args = both_orientations(args)
    both = time_euka_call(
        "euka scorer, synthetic 1,000-bp reads of both orientations", args,
        ek.score_batch(*args), smi)
    return dict(calls=rows, share_of_map_score=total / 1e3 / map_score_s,
                long=long, long_both=both,
                max_abs_err=max([r["max_abs_err"] for r in rows]
                                + [long["max_abs_err"], both["max_abs_err"]]))


def phase_euka(dev, out_dir, clock):
    from vgan_tpu_torch import cli
    from vgan_tpu_torch.infer import abundance_mcmc as am
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.pipelines import euka as ek
    from vgan_tpu_torch.pipelines.euka_runner import (
        abundance_mcmc_from_result)
    from vgan_tpu_torch.utils import profiling

    euka_dir, d5, d3, fq, n_reads = build_euka_world(out_dir)
    prefix = os.path.join(out_dir, "euka_out")
    argv = (["euka", "--euka_dir", euka_dir, "-fq1", fq, "-o", prefix,
             "--deam5p", d5, "--deam3p", d3, "--device", str(dev),
             "--profile"] + EUKA_GATES)
    profiling.enable()
    runs = []
    # the warm-up run keeps each chain segment's inputs and each scorer
    # call's inputs and outputs
    segment, seg_calls = am.run_segment, []
    score, score_calls = ek.score_batch, []

    def keeping(*args):
        seg_calls.append(args)
        return segment(*args)

    def keeping_score(*args):
        out = score(*args)
        score_calls.append((args, out))
        return out

    sw.reset_launches()
    am.reset_launches()
    ek.reset_launches()
    for i in range(3):  # one warm-up run, two timed
        for f in os.listdir(out_dir):
            if f.startswith("euka_out_"):
                os.remove(os.path.join(out_dir, f))
        profiling.PROFILER.clear()
        before = dict(sw.LAUNCHES, **am.LAUNCHES, **ek.LAUNCHES)
        am.run_segment = segment if i else keeping
        ek.score_batch = score if i else keeping_score
        try:
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise AssertionError("cli euka failed")
            wall = time.perf_counter() - t0
        finally:
            am.run_segment = segment
            ek.score_batch = score
        if sw.LAUNCHES["gather_score_hash"] <= before["gather_score_hash"] \
                or am.LAUNCHES["abundance_mcmc_segment"] <= before[
                    "abundance_mcmc_segment"] \
                or ek.LAUNCHES["euka_score"] <= before["euka_score"]:
            raise AssertionError(f"euka run {i} launched no SW kernel, no "
                                 "chain kernel or no scorer kernel")
        medians = check_euka_outputs(prefix)
        ms = profiling.PROFILER.stages["map+score"].seconds
        mc = profiling.PROFILER.stages["mcmc"].seconds
        mstages = {n: profiling.PROFILER.stages[n].seconds for n in (
            "mapper.submit", "mapper.collect", "mapper.finalize")}
        mstages["chunks"] = profiling.PROFILER.stages["mapper.submit"].calls
        runs.append(dict(wall_s=wall, map_score_s=ms, mcmc_s=mc,
                         stages=mstages))
        log(f"euka run {i} ({'warm-up' if i == 0 else 'timed'}): "
            f"{wall:.2f} s wall, map+score {ms:.3f} s = "
            f"{n_reads / ms:.0f} reads/s, mcmc {mc:.3f} s = "
            f"{EUKA_STEPS / mc:.0f} iterations/s; "
            f"{ek.LAUNCHES['euka_score'] - before['euka_score']} euka_score "
            f"launches; medians "
            + json.dumps(medians) + "; mapper stages "
            + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in mstages.items()}))
    launches = dict(sw.LAUNCHES, **am.LAUNCHES, **ek.LAUNCHES)
    log(f"euka: detected exactly the planted taxa in all runs; kernel "
        f"launches in the 3 runs: {launches}")
    scorer = check_euka_scorer(score_calls, runs[0]["map_score_s"],
                               clock.smi)
    chain = check_chain_kernel(seg_calls[-1], clock.smi)
    cmp, res = compare_card_cpu(dev, euka_dir, d5, d3, fq, clock)

    def cli_run():
        if cli.main(argv) != 0:
            raise AssertionError("profiled cli euka failed")

    prof = dict(cli_run=profile_call(cli_run),
                mcmc=profile_call(lambda: abundance_mcmc_from_result(
                    res, n_iter=EUKA_ITER, burnin=EUKA_BURNIN, device=dev)))
    log("euka profiled: " + json.dumps(prof))
    timed = runs[1:]
    return dict(launches=launches, runs=runs, compare=cmp, profile=prof,
                chain=chain, scorer=scorer,
                reads_per_s=[n_reads / r["map_score_s"] for r in timed],
                mcmc_iters_per_s=[EUKA_STEPS / r["mcmc_s"] for r in timed],
                cli_wall_s=[r["wall_s"] for r in timed])


# ----------------------------------------------------------------- phase 6
def build_soibean_world(out_dir):
    """The soibean DB and reads (see the module docstring), through
    tests/_torch_world.py's functions over the port's synth. Returns
    (db_dir, fastq, planted leaf names, their parents, n_reads)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _torch_world as world
    from vgan_tpu_torch.graph import synth
    from vgan_tpu_torch.utils.newick import parse_newick

    t0 = time.perf_counter()
    tw = world.random_tree(SB_LEAVES, 7)
    graph, private = world.build_tree_graph(
        synth, tw, SB_BP, SB_SITES_PER_UNIT, node_len=SB_NODE_LEN, seed=5)
    db_dir = world.write_soibean_db(os.path.join(out_dir, "soibean"),
                                    SB_PREFIX, graph, tw[0],
                                    (0.3, 0.2, 0.22, 0.28))
    planted = sorted((n for n in private if n.startswith("L")),
                     key=lambda n: -private[n])[:3]
    fq = os.path.join(out_dir, "soibean_reads.fq")
    n_reads = len(world.write_source_fastq(
        synth, graph, fq, list(zip(planted, SB_MIX)), read_len=SB_READ_LEN))
    tree = parse_newick(tw[0])
    parents = {n: tree.names[tree.parent[tree.names.index(n)]]
               for n in planted}
    log(f"soibean world: a {tree.n_nodes}-node tree, {graph.n_paths} paths, "
        f"{graph.n_nodes} nodes, {sum(private.values())} variants; "
        f"{n_reads} reads of {planted} ({[private[n] for n in planted]} "
        f"private variants) ({time.perf_counter() - t0:.1f} s)")
    return db_dir, fq, planted, parents, n_reads


def check_soibean_outputs(prefix, planted, parents, sig_names):
    """Every output file for k = 1..3, the signature paths exactly the
    planted leaves, and at k = 3 the chain of the highest log-likelihood
    ending on the planted leaves (or their parents) with mean proportions
    within 0.15 of SB_SHARES. Returns that chain's {source: proportion}."""
    if sorted(sig_names) != sorted(planted):
        raise AssertionError(f"soibean signature paths {sig_names}, "
                             f"planted {planted}")
    files = []
    for k in range(1, 4):
        files += [f"{prefix}ProportionEstimates{k}.txt",
                  f"{prefix}BranchEstimate{k}.txt",
                  f"{prefix}Diagnostics{k}0.txt"]
        files += [f"{prefix}{kind}{k}{c}{ext}" for c in range(SB_CHAINS)
                  for kind, ext in (("Result", ".mcmc"),
                                    ("Trace", ".detail.mcmc"))]
    missing = [f for f in files if not os.path.exists(f)]
    if missing or os.path.exists(f"{prefix}Diagnostics40.txt"):
        raise AssertionError(f"soibean outputs missing {missing} (or k > 3)")
    with open(f"{prefix}Diagnostics30.txt") as f:
        best = int(f.read().splitlines()[1].split("\t")[2])
    with open(f"{prefix}ProportionEstimates3.txt") as f:
        rows = [l.split("\t") for l in f.read().splitlines()[1:]]
    got = {r[0]: float(r[2]) for r in rows if int(r[1]) == best}
    owner = {}
    for name in got:
        leaf = [n for n in planted if name in (n, parents[n])]
        if len(leaf) != 1 or leaf[0] in owner.values():
            raise AssertionError(f"soibean k=3 chain {best} ends on "
                                 f"{sorted(got)}, planted {planted}")
        owner[name] = leaf[0]
    for name, share in got.items():
        want = SB_SHARES[planted.index(owner[name])]
        if abs(share - want) > 0.15:
            raise AssertionError(f"soibean {name}: mean proportion {share} "
                                 f"vs {want}")
    return got


def tree_bound_ms(mask, S, R, count_bytes, hops):
    """(least milliseconds, "bytes" or "operations") for S steps of the
    rows in `mask` [B, K]: every input read once and every output written
    once (the path-major tables [P, R] f64 and [P, R, 25], the noise and
    the trace), against the f64 multiply-adds of the counts' dot products
    (25 a read and source slice, two slices an active source) at the
    card's f64 rate, whichever takes longer. Also returns the
    milliseconds a step takes to stream its slices from device memory
    when each is read anew (the kernel's design)."""
    B, K = mask.shape
    P = count_bytes["P"]
    nbytes_once = (P * R * 8 + P * R * 25 * count_bytes["size"]
                   + S * B * (K * (2 + 4 * hops) + 1) * 4
                   + S * B * (K * 20 + 8))
    fma = S * int(mask.sum()) * 2 * R * 25
    t_bytes = nbytes_once / HBM_BYTES_PER_S
    t_ops = fma / F64_FMA_PER_S
    streamed = int(mask.sum()) * 2 * R * (25 * count_bytes["size"] + 8)
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            streamed / HBM_BYTES_PER_S * 1e3)


def check_tree_kernel(dev, call, smi):
    """The kernel against its plain version on the card and on the CPU,
    over SB_CHECK_BURN + SB_CHECK_POST steps of the run's own k-sweep
    batch (`call`: the arguments of run_tree_mcmc_ksweep in the CLI run),
    noise drawn once, at every cluster size the wrapper can choose for
    the batch (tm.card_cluster_sizes), the plain versions run once; node
    ids exact, positions, proportions and log-likelihoods to rtol 1e-10.
    Then timed at each size: the kernel a step over SB_TIMED_STEPS
    post-burn-in and burn-in steps, and the serial floor (the same steps
    with R cut to 32 reads a CTA); at the chosen size also over a
    runner's segment, and the plain version a step on the card over
    SB_TIMED_STEPS, beside the bound."""
    import functools

    import numpy as np
    import torch

    from vgan_tpu_torch.infer import tree_mcmc as tm

    args, kw = call
    tree, data = args[0], args[1]
    srcs, mask, theta0, ll0, seeds = tm.ksweep_rows(
        args[3], kw["init_logls"], kw["seeds_per_k"], dev)
    B, K = srcs.shape
    P, R = data.path_map_t.shape
    N, Cc = data.tree.children.shape
    sizes = tm.card_cluster_sizes(dev, B, K, N, Cc, data.counts25_t.dtype)
    chosen = sizes[0]
    sd_all = tm.sd_schedule(SB_ITER, SB_BURNIN, kw["num_paths"])
    burn_hops = tm.burn_walk_hops(kw["num_paths"])
    post0 = SB_BURNIN + 1
    plan = ((0, SB_CHECK_BURN, burn_hops),
            (post0, post0 + SB_CHECK_POST, tm.POST_BURN_HOPS))
    cpu_data = tm.prepare(tree, data.path_map_t.T.cpu().numpy(),
                          data.counts25_t.permute(1, 0, 2).cpu().numpy(),
                          dict(zip(tm.FREQ_KEYS, data.freq.tolist())),
                          data.con, "cpu")
    runs = {f"kernel G={G}": (functools.partial(tm.run_segment, cluster=G),
                              data) for G in sizes}
    runs.update({"plain": (tm.run_segment_plain, data),
                 "cpu": (tm.run_segment, cpu_data)})
    start = (torch.as_tensor(srcs), torch.full((B, K), 0.5,
                                                dtype=torch.float64),
             theta0.cpu(), torch.as_tensor(ll0))
    carry = {n: tuple(x.to(d.device) for x in start)
             for n, (_f, d) in runs.items()}
    mask_t = torch.as_tensor(mask)
    recs = {n: [] for n in runs}
    secs = {n: 0.0 for n in runs}
    tm.reset_launches()  # these launches are not the main path's
    for i0, i1, hops in plan:
        noise = tm.draw_noise(seeds, i0, i1, K, hops, "cpu")
        for name, (fn, d) in runs.items():
            on = d.device
            t0 = time.perf_counter()
            carry[name], rec = fn(
                *carry[name], mask_t.to(on), torch.arange(i0, i1, device=on),
                torch.from_numpy(sd_all[i0:i1]).to(on),
                tm.Noise(*(x.to(on) for x in noise)), d.path_map_t,
                d.counts25_t, d.tree, d.con, d.freq)
            if on.type == "cuda":
                torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            recs[name].append([x.cpu() for x in rec])
    max_err = {}
    for G in sizes:
        name = f"kernel G={G}"
        max_err[G] = 0.0
        for other in ("plain", "cpu"):
            for a, b in zip(recs[name], recs[other]):
                if not torch.equal(a[0], b[0]):
                    raise AssertionError(f"tree {name} vs {other}: node ids "
                                         "differ")
                for x, y in zip(a[1:], b[1:]):
                    bad = (x - y).abs() > 1e-10 * y.abs()
                    if bool(bad.any()):
                        raise AssertionError(
                            f"tree {name} vs {other}: {int(bad.sum())} "
                            "values past rtol 1e-10")
                    max_err[G] = max(max_err[G], float((x - y).abs().max()))
    ll_rec = torch.cat([r[3] for r in recs[f"kernel G={chosen}"]],
                       dim=1).numpy()
    acc = float((np.diff(ll_rec, axis=1) != 0).mean())
    steps = SB_CHECK_BURN + SB_CHECK_POST
    log(f"tree kernel vs plain on the card and on the CPU: {steps} steps of "
        f"the k-sweep batch (B={B}, Kmax={K}, R={R}, P={P}, {burn_hops} then "
        f"{tm.POST_BURN_HOPS} hops) at clusters of {sizes} CTAs a row "
        f"(chosen {chosen}): ids equal, max abs err "
        + json.dumps({str(G): e for G, e in max_err.items()})
        + f"; acceptance {acc:.3f}; seconds "
        + json.dumps({n: round(t, 3) for n, t in secs.items()}))

    # timing: the post-burn-in walk from the checked carry, then burn-in
    cb = dict(P=P, size=data.counts25_t.element_size())
    c0 = carry[f"kernel G={chosen}"]
    out = {"sizes": sizes, "chosen": chosen, "by_size": {}}
    for label, i0, n, hops in (("post", post0, SB_TIMED_STEPS,
                                tm.POST_BURN_HOPS),
                               ("burn", 0, SB_TIMED_STEPS, burn_hops)):
        noise = tm.draw_noise(seeds, i0, i0 + n, K, hops, dev)
        seg = (mask_t.to(dev), torch.arange(i0, i0 + n, device=dev),
               torch.from_numpy(sd_all[i0:i0 + n]).to(dev), noise)
        bms, by, stream_ms = tree_bound_ms(mask, n, R, cb, hops)
        for G in sizes:
            rf = G * 32  # the serial floor: 32 reads a CTA
            ms = cuda_ms(lambda: tm.run_segment(
                *(x.clone() for x in c0), *seg, data.path_map_t,
                data.counts25_t, data.tree, data.con, data.freq,
                cluster=G), reps=5)
            pm_f = data.path_map_t[:, :rf].contiguous()
            c25_f = data.counts25_t[:, :rf].contiguous()
            floor_ms = cuda_ms(lambda: tm.run_segment(
                *(x.clone() for x in c0), *seg, pm_f, c25_f, data.tree,
                data.con, data.freq, cluster=G), reps=5)
            out["by_size"].setdefault(str(G), {})[label] = dict(
                us_a_step=1e3 * ms / n, floor_us_a_step=1e3 * floor_ms / n)
            log(f"tree kernel, {'post-burn-in' if label == 'post' else 'burn-in'}"
                f" walk ({hops} hops), clusters of {G}: {ms:.3f} ms for {n} "
                f"steps = {1e3 * ms / n:.2f} us a step "
                f"({100 * bms / ms:.2f} % of the {bms:.4f} ms bound, {by}); "
                f"serial floor (R = {rf}) {1e3 * floor_ms / n:.2f} us a step; "
                f"on {smi}")
            if G == chosen:
                out[label] = dict(ms=ms, steps=n, hops=hops, bound_ms=bms,
                                  bound_by=by, floor_ms=floor_ms,
                                  streamed_ms_a_step=stream_ms)
        if label == "post":
            full = seg + (data.path_map_t, data.counts25_t, data.tree,
                          data.con, data.freq)
            out[label]["plain_ms"] = cuda_ms(
                lambda: tm.run_segment_plain(*(x.clone() for x in c0), *full),
                reps=1, warmup=0)
            log(f"tree plain version on the card: "
                f"{out[label]['plain_ms'] / n:.2f} ms a step; {stream_ms * 1e3:.3f} "
                f"us a step if every slice streamed from HBM; on {smi}")
    # one segment as the runner cuts the post-burn-in walk, at its choice
    S_run = tm.segment_plan(SB_ITER + 1, SB_BURNIN, kw["num_paths"], B,
                            K)[-2]
    n = S_run[1] - S_run[0]
    noise = tm.draw_noise(seeds, S_run[0], S_run[1], K, S_run[2], dev)
    seg = (mask_t.to(dev), torch.arange(S_run[0], S_run[1], device=dev),
           torch.from_numpy(sd_all[S_run[0]:S_run[1]]).to(dev), noise,
           data.path_map_t, data.counts25_t, data.tree, data.con, data.freq)
    out["segment"] = dict(steps=n, ms=cuda_ms(
        lambda: tm.run_segment(*(x.clone() for x in c0), *seg), reps=2))
    log(f"tree kernel, one runner segment of {n} steps (clusters of "
        f"{chosen}): {out['segment']['ms']:.2f} ms = "
        f"{1e3 * out['segment']['ms'] / n:.2f} us a step on {smi}")
    return dict(max_abs_err=max(max_err.values()), max_abs_err_by_size={
        str(G): e for G, e in max_err.items()}, acceptance=acc,
        check_s=secs, B=B, K=K, R=R, P=P, **out)


def phase_soibean(dev, out_dir, clock):
    from vgan_tpu_torch import cli
    from vgan_tpu_torch.infer import patristic as pt
    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.utils import profiling

    db_dir, fq, planted, parents, n_reads = build_soibean_world(out_dir)
    prefix = os.path.join(out_dir, "sb_")
    argv = ["soibean", "--soibean_dir", db_dir, "--dbprefix", SB_PREFIX,
            "-fq1", fq, "-o", prefix, "--chains", str(SB_CHAINS), "--iter",
            str(SB_ITER), "--burnin", str(SB_BURNIN), "--device", str(dev),
            "--profile"]
    smi = clock.smi
    # each run's k-sweep call: its arguments and its seconds; the warm-up
    # run's SW kernel calls: their inputs and outputs
    ksweep, calls = tm.run_tree_mcmc_ksweep, []
    kernel, sw_calls = sw.gather_score_hash, []

    def keeping(*args, **kw):
        t0 = time.perf_counter()
        out = ksweep(*args, **kw)
        calls.append(((args, kw), time.perf_counter() - t0))
        return out

    def keeping_sw(*args):
        out = kernel(*args)
        sw_calls.append((args, out))
        return out

    profiling.enable()
    runs = []
    sw.reset_launches()
    tm.reset_launches()
    pt.reset_launches()
    tm.run_tree_mcmc_ksweep = keeping
    try:
        for i in range(3):  # one warm-up run, two timed
            for f in os.listdir(out_dir):
                if f.startswith("sb_"):
                    os.remove(os.path.join(out_dir, f))
            profiling.PROFILER.clear()
            sw.gather_score_hash = kernel if i else keeping_sw
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise AssertionError("cli soibean failed")
            wall = time.perf_counter() - t0
            sw.gather_score_hash = kernel
            st = {k: profiling.PROFILER.stages[k].seconds
                  for k in ("map", "analyse", "tree_mcmc")}
            (args, kw), sampler_s = calls[-1]
            tree = args[0]
            sig = [tree.names[n] for n in args[3][-1][0]]
            shares = check_soibean_outputs(prefix, planted, parents, sig)
            rows = sum(s.shape[0] for s in args[3])
            runs.append(dict(wall_s=wall, stages_s=st, sampler_s=sampler_s,
                             rows=rows, shares=shares))
            e2e_s = st["map"] + st["analyse"] + st["tree_mcmc"]
            log(f"soibean run {i} ({'warm-up' if i == 0 else 'timed'}): "
                f"{wall:.2f} s wall; stages {json.dumps(st)}; "
                f"{n_reads / e2e_s:.1f} reads/s over map + analyse + "
                f"tree_mcmc; k-sweep sampler {sampler_s:.2f} s for {rows} "
                f"rows x {SB_ITER + 1} steps; k=3 best chain "
                + json.dumps(shares))
    finally:
        tm.run_tree_mcmc_ksweep = ksweep
        sw.gather_score_hash = kernel
    launches = dict(sw.LAUNCHES, **tm.LAUNCHES, **pt.LAUNCHES)
    if min(launches["tree_mcmc_segment"], launches["gather_score_hash"],
           launches["patristic_series"]) < 1:
        raise AssertionError(f"soibean runs launched {launches}")
    log(f"soibean: signature paths = planted {planted} and the k=3 best "
        f"chain on them in all runs; kernel launches in the 3 runs: "
        f"{launches}")
    sb_sw = check_sw_calls("soibean", sw_calls, clock)
    tree_kernel = check_tree_kernel(dev, calls[-1][0], smi)
    timed = runs[1:]
    e2e = [n_reads / sum(r["stages_s"][k] for k in ("map", "analyse",
                                                    "tree_mcmc"))
           for r in timed]
    iters = [r["rows"] * (SB_ITER + 1) / r["stages_s"]["tree_mcmc"]
             for r in timed]
    sampler = [r["rows"] * (SB_ITER + 1) / r["sampler_s"] for r in timed]
    log(f"soibean: soibean_e2e_reads_per_s "
        f"{', '.join(f'{x:.1f}' for x in e2e)}; soibean_mcmc_iters_per_s "
        f"{', '.join(f'{x:.0f}' for x in iters)} (the sampler alone "
        f"{', '.join(f'{x:.0f}' for x in sampler)}) on {smi}")
    return dict(launches=launches["tree_mcmc_segment"],
                sw_launches=launches["gather_score_hash"],
                patristic_launches=launches["patristic_series"], runs=runs,
                kernel=tree_kernel, sw=sb_sw, reads_per_s=e2e,
                mcmc_iters_per_s=iters, sampler_iters_per_s=sampler,
                ksweep_call=calls[-1][0])


def check_patristic(dev, smi):
    """patristic_series_kernel at the benchmark cell's shape (PT_STATES
    chain-like states, PT_LEAVES leaves): the wrapper's series bit-equal
    to the plain version's; the kernel alone timed by events and on the
    device alone beside its bound, the whole wrapper call (upload, kernel,
    download) and the plain version and the held host function (which
    rebuilds the tables) on the host clock. One line."""
    import ctypes

    import numpy as np
    import torch

    from vgan_tpu_torch._native import patristic_lib
    from vgan_tpu_torch.bench import random_tree
    from vgan_tpu_torch.infer import diagnostics as dg
    from vgan_tpu_torch.infer import patristic as pt
    from vgan_tpu_torch.utils.newick import parse_newick

    tree = parse_newick(random_tree(PT_LEAVES, PT_TREE_SEED)[0])
    rng = np.random.default_rng(PT_TREE_SEED)
    runs = rng.integers(0, tree.n_nodes, size=PT_STATES // 50 + 1)
    nodes = np.repeat(runs, 50)[:PT_STATES].astype(np.int32)
    pos = rng.random(PT_STATES)
    tables = pt.patristic_tables(tree)

    def host_s(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    pt.patristic_distance_series(tables, nodes, pos, dev)  # warm-up
    got, call_s = host_s(
        lambda: pt.patristic_distance_series(tables, nodes, pos, dev))
    plain, plain_s = host_s(
        lambda: pt.patristic_series_plain(tables, nodes, pos))
    held, held_s = host_s(lambda: dg.patristic_distance_series(tree, nodes,
                                                               pos))
    if got.tobytes() != plain.tobytes() or got.tobytes() != held.tobytes():
        raise AssertionError("patristic_series_kernel: the series differs "
                             "from the plain version's bytes")
    dn, dl, dist = tables.on(dev)
    nodes_t = torch.from_numpy(nodes).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    out = torch.empty(PT_STATES, dtype=torch.float64, device=dev)
    lib = patristic_lib()
    args = [ctypes.c_void_p(t.data_ptr())
            for t in (dn, dl, dist, nodes_t, pos_t)]

    def launch():
        rc = lib.patristic_series_launch(
            *args, PT_LEAVES, PT_STATES, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"patristic_series_launch: CUDA error {rc}")

    ms = cuda_ms(launch, reps=50)
    dev_ms = queued_ms(launch, 50)
    if out.cpu().numpy().tobytes() != plain.tobytes():
        raise AssertionError("patristic_series_kernel: a timed launch "
                             "differs from the plain version")
    ops = PT_STATES * (PT_OPS_PER_TERM * PT_LEAVES + PT_OPS_PER_STATE)
    bms, by = f64_bound_ms(ops, PT_BYTES_PER_STATE * PT_STATES)
    dev_txt = ("device time not measured" if dev_ms is None else
               f"on the device alone {dev_ms:.4f} ms = "
               f"{100 * bms / dev_ms:.1f} %")
    log(f"patristic_series_kernel ({PT_STATES} states, {PT_LEAVES} leaves): "
        f"bit-equal to the plain version; kernel {ms:.4f} ms "
        f"({100 * bms / ms:.1f} % of the {bms:.4f} ms bound, {by}-bound; "
        f"{dev_txt}); the wrapper call {1e3 * call_s:.2f} ms (upload, "
        f"kernel, download); plain {1e3 * plain_s:.1f} ms; the held host "
        f"function {1e3 * held_s:.1f} ms; on {smi}")
    return dict(ms=ms, device_ms=dev_ms, call_ms=1e3 * call_s,
                plain_ms=1e3 * plain_s, held_ms=1e3 * held_s, bound_ms=bms,
                bound_by=by, states=PT_STATES, leaves=PT_LEAVES,
                max_abs_err=0.0)


# ----------------------------------------------------------------- phase 7
def build_keelime_world(out_dir):
    """The keelime DB, reads and damage profiles (see the module
    docstring), through tests/_torch_world.py's functions over the port's
    synth. Returns (db_dir, fastq, d5, d3, path name, haplotype length)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _torch_world as world
    from vgan_tpu_torch.graph import synth

    t0 = time.perf_counter()
    graph, _ = synth.build_haplotype_graph(
        world.backbone(KL_BP, 7), n_haplotypes=KL_HAPS,
        n_variants=KL_VARIANTS, seed=3)
    db_dir = os.path.join(out_dir, "db")
    os.makedirs(db_dir)
    graph.save(os.path.join(db_dir, "graph.npz"))
    fq = os.path.join(out_dir, "reads.fq")
    world.write_fastq(fq, synth.sample_reads(graph, KL_HAP, KL_READS,
                                             read_len=KL_READ_LEN, seed=0))
    d5, d3 = world.write_damage_profiles(out_dir)
    hap_len = len(graph.path_seq(KL_HAP))
    log(f"keelime world: {graph.n_paths} haplotypes, {graph.n_nodes} nodes, "
        f"{KL_READS} {KL_READ_LEN}-bp reads of a {hap_len}-bp haplotype "
        f"({time.perf_counter() - t0:.1f} s)")
    return db_dir, fq, d5, d3, graph.path_names[KL_HAP], hap_len


def overlap_work(la, lb, won, min_olen, table_bytes):
    """(cells, bytes) of an overlap scan of the pairs with lengths (la,
    lb) and results `won` (the lengths found): the cells are those the
    scan of cpp/overlapbest.cpp::best_one visits, counted on the host (the
    whole full-length block; the tail block only where the full block
    fails, up to the winning start); the bytes are the sequence table and
    its offsets (`table_bytes`) and the pairs' two int32 indices read
    once, and the two outputs written once."""
    import numpy as np

    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    won = np.asarray(won, dtype=np.int64)
    valid = (la >= min_olen) & (lb > 0)
    n_full = la - lb + 1
    full = valid & (n_full > 0) & (lb >= min_olen)
    cells = int(np.where(full, n_full * lb, 0).sum())
    tail = valid & ~(full & (won == lb))
    t0 = np.maximum(n_full, 0)
    last = np.where(won > 0, la - won, la - min_olen)  # last start scanned
    count = np.where(tail, np.maximum(last - t0 + 1, 0), 0)
    # olen = la - s over s = t0 .. last: an arithmetic series
    cells += int((count * ((la - t0) + (la - last)) // 2).sum())
    return cells, table_bytes + 24 * len(la)


def overlap_bound_ms(cells, nbytes):
    """(least milliseconds, "operations" or "bytes"): the cells'
    OVERLAP_OPS_PER_CELL lane operations over 132 SMs x 128 lanes at
    1.98 GHz, against the bytes over 3.35 TB/s."""
    t_ops = cells * OVERLAP_OPS_PER_CELL / (SMS * SM_LANES * CLOCK_HZ)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def conv_library(pairs, min_olen, min_score, dev):
    """One PyTorch library call computing the overlap scans: the [N, La]
    score matrix of every chunk as a grouped conv1d (cuDNN, f32, TF32
    off: every partial sum is a small multiple of 0.5, exact in f32) of
    one-hot(a) with the table-weighted one-hot(b), on chunks bucketed as
    JAX's overlap_scores_batch buckets them, then the winner rule as torch
    ops. Returns (its results, the milliseconds of that one run on the
    card, its inputs already there)."""
    import torch
    import torch.nn.functional as F

    from vgan_tpu_torch.pipelines import keelime_device as kd

    torch.backends.cudnn.allow_tf32 = False
    lut, t2 = kd.code_tables()
    lut_t = torch.from_numpy(lut.astype("int64")).to(dev)
    tab = torch.from_numpy(t2.astype("float32") / 2).to(dev)  # [16, 16]
    chunks = []
    for A, B, la, lb, nb in kd.padded_chunks(pairs, 4096, dev):
        # rows padded to the chunk, or to a multiple of 256: JAX's buckets
        N = 4096 if nb == 4096 else kd._bucket(nb, 256)
        A, B = (F.pad(t, (0, 0, 0, N - nb)) for t in (A, B))
        la, lb = (F.pad(t, (0, N - nb)) for t in (la, lb))
        La = A.shape[1]
        Lb = B.shape[1]
        ca, cb = lut_t[A.long()], lut_t[B.long()]
        # padding: positions past a's or b's length weigh nothing
        ca = torch.where(torch.arange(La, device=dev) < la[:, None], ca, -1)
        x = F.one_hot(ca + 1, kd.N_CODES + 1)[..., 1:].float()  # [N, La, 16]
        x = F.pad(x.permute(0, 2, 1), (0, Lb)).reshape(1, N * kd.N_CODES,
                                                      La + Lb)
        w = tab[:, cb].permute(1, 0, 2)  # [N, 16, Lb]: T[c, b[j]]
        w = torch.where(torch.arange(Lb, device=dev) < lb[:, None, None], w,
                        0.0).contiguous()
        chunks.append((x, w, la, lb, nb, La))

    def run():
        out = []
        for x, w, la, lb, nb, La in chunks:
            S = F.conv1d(x, w, groups=w.shape[0])[0, :, :La]
            out.append([t[:nb] for t in kd.winner(S, la, lb, min_olen,
                                                   min_score)])
        return out

    return timed_once(run)


def timed_once(run):
    """(run()'s [length, score] chunks as one list of (length, score),
    the milliseconds of that one run on the card by CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = run()
    end.record()
    torch.cuda.synchronize()
    ln = torch.cat([r[0] for r in res]).cpu().tolist()
    sc = torch.cat([r[1] for r in res]).cpu().tolist()
    return list(zip(ln, sc)), start.elapsed_time(end)


def kernel_vs_plain(scan, plain, args, n, hints):
    """(kernel's outputs, plain version's outputs, the plain version's
    milliseconds, what the kernel's wrapper returned): both written into
    outputs preset to (-7, -7.0), so the pairs of the other class must
    stay untouched by both; `hints` (n_long, longest) follow the
    outputs."""
    import torch

    outs, ret = [], []
    for fn in (scan, plain):
        out = (torch.full((n,), -7, dtype=torch.int64, device=args[0].device),
               torch.full((n,), -7.0, dtype=torch.float64,
                          device=args[0].device))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ret.append(fn(*args, *out, *hints))
        torch.cuda.synchronize()
        outs.append(out)
    return outs[0], outs[1], (time.perf_counter() - t0) * 1e3, ret[0]


def kernel_line(name, c):
    """One kernel's part of an overlap call's log line."""
    g = f" (clusters of {c['cluster']})" if "cluster" in c else ""
    return (f"{name} kernel {c['pairs']} pairs{g} {c['ms']:.4f} ms "
            f"({100 * c['bound_ms'] / c['ms']:.2f} % of "
            f"{c['bound_ms']:.4f} ms), plain {c['plain_ms']:.2f} ms, "
            f"conv1d {c['library_ms']:.2f} ms, max abs err "
            f"{c['max_abs_err']}")


def check_overlap_calls(dev, calls, smi):
    """Each overlap_best_indexed call of a keelime run on the card: the
    warp kernel and the block kernel, each alone on its class of the split
    (where the class has pairs), against their plain versions on the card
    (exactly; the other class untouched); the call's results against the
    two plain versions together, the native scan on the CPU and the
    library's conv1d. Each kernel's max_abs_err is the largest difference
    in length or score over its own pairs, between its results alone, the
    call's and its plain version's, and the call's and the native scan's.
    Each kernel timed alone (CUDA events, 5 calls) beside its bound, and
    the whole call; the plain versions and the library on the card (one
    checked run, inputs already there), the native scan on the host's
    threads."""
    import torch

    from vgan_tpu_torch.pipelines import keelime_device as kd

    def max_err(x, y, ks):
        return max(float((x[k][ks].double() - y[k][ks].double()).abs().max())
                   for k in (0, 1))

    rows = []
    for i, (*args, got) in enumerate(calls):
        buf, off, ai, bi, min_olen, min_score = args[:6]
        n = ai.numel()
        host = [t.cpu() for t in (buf, off, ai, bi)]
        t0 = time.perf_counter()
        nat = kd.overlap_best_indexed(*host, min_olen, min_score)
        native_ms = (time.perf_counter() - t0) * 1e3
        nat = tuple(t.to(dev) for t in nat)
        la_d = off[ai.long() + 1] - off[ai.long()]
        order, n_short = kd.split_by_length(la_d)
        scan_args = (buf, off, ai, bi, order, n_short, min_olen, min_score)
        hints = (kd.count_long(host[1].numpy(), host[2].numpy()),
                 kd.longest_of(host[1].numpy()))
        la, lb = (x.numpy() for x in (
            host[1][host[2].long() + 1] - host[1][host[2].long()],
            host[1][host[3].long() + 1] - host[1][host[3].long()]))
        won = got[0].cpu().numpy()
        buf_h, off_h = host[0].numpy(), host[1].numpy()
        contents = [buf_h[off_h[k]:off_h[k + 1]].tobytes().decode("latin-1")
                    for k in range(len(off_h) - 1)]
        k_short = int(n_short)
        # both plain classes together are the plain version of the call
        whole = (torch.full((n,), -7, dtype=torch.int64, device=dev),
                 torch.full((n,), -7.0, dtype=torch.float64, device=dev))
        classes = {}
        for name, scan, plain, ks in (
                ("warp", kd.warp_scan, kd.plain_warp_scan, order[:k_short]),
                ("block", kd.block_scan, kd.plain_block_scan,
                 order[k_short:])):
            if not ks.numel():
                continue
            ks = ks.long()
            mine, ref, plain_ms, ran = kernel_vs_plain(scan, plain,
                                                       scan_args, n, hints)
            if not (torch.equal(mine[0], ref[0])
                    and torch.equal(mine[1], ref[1])):
                raise AssertionError(f"overlap call {i}: {name} kernel vs "
                                     "plain")
            for w, r in zip(whole, ref):
                w[ks] = r[ks]
            ms = cuda_ms(lambda: scan(*scan_args, *mine, *hints), reps=5)
            ks_h = ks.cpu().numpy()
            cells, nbytes = overlap_work(la[ks_h], lb[ks_h], won[ks_h],
                                         min_olen,
                                         buf.numel() + 8 * off.numel())
            bms, by = overlap_bound_ms(cells, nbytes)
            pairs = [(contents[a], contents[b]) for a, b in
                     zip(host[2].numpy()[ks_h], host[3].numpy()[ks_h])]
            library, library_ms = conv_library(pairs, min_olen, min_score,
                                               dev)
            want = list(zip(ref[0][ks].tolist(), ref[1][ks].tolist()))
            if library != want:
                raise AssertionError(f"overlap call {i}: {name} kernel vs "
                                     "library conv1d")
            classes[name] = dict(pairs=len(ks_h), cells=cells, bytes=nbytes,
                                 ms=ms, plain_ms=plain_ms,
                                 library_ms=library_ms, bound_ms=bms,
                                 bound_by=by, max_len=int(la[ks_h].max()),
                                 max_abs_err=max(max_err(mine, ref, ks),
                                                 max_err(got, ref, ks),
                                                 max_err(got, nat, ks)))
            if name == "block":  # block_scan returns its cluster size
                classes[name]["cluster"] = ran
        for name, other in (("plain", whole), ("native", nat)):
            if not (torch.equal(got[0], other[0])
                    and torch.equal(got[1], other[1])):
                bad = int((got[0] != other[0]).sum())
                raise AssertionError(f"overlap call {i}: kernels vs {name}: "
                                     f"{bad} of {n} lengths differ")
        call_ms = cuda_ms(lambda: kd.overlap_best_indexed(*args), reps=5)
        cells, nbytes = overlap_work(la, lb, won, min_olen,
                                     buf.numel() + 8 * off.numel())
        bms, by = overlap_bound_ms(cells, nbytes)
        row = dict(pairs=n, max_len=int(la.max()), min_olen=min_olen,
                   cells=cells, bytes=nbytes, call_ms=call_ms,
                   native_ms=native_ms, bound_ms=bms, bound_by=by, **classes)
        rows.append(row)
        log(f"overlap call {i}: {n} pairs (longest a {row['max_len']} bp, "
            f"min_olen {min_olen}), {cells} cells: the call {call_ms:.4f} "
            f"ms ({100 * bms / call_ms:.2f} % of the {bms:.4f} ms bound, "
            f"{by}-bound), native scan {native_ms:.2f} ms; "
            + "; ".join(kernel_line(k, c) for k, c in classes.items())
            + "; every kernel equal to its plain version, the call to "
            f"plain, native and conv1d; on {smi}")
    return rows


def cluster_sweep(dev, call, row, smi):
    """overlap_best_kernel on the long class of one merge call (the
    16,569-bp call with the most pairs) at the cluster size it chooses
    and forced to every size of CLUSTER_SIZES: each held bit-equal to
    plain_block_scan on the card and timed alone (CUDA events, 5 calls)
    beside the class's bound. Returns {"chosen": G, "ms": {G: ms}}."""
    import torch

    from vgan_tpu_torch.pipelines import keelime_device as kd

    buf, off, ai, bi, min_olen, min_score = call[:6]
    n = ai.numel()
    order, n_short = kd.split_by_length(off[ai.long() + 1] - off[ai.long()])
    args = (buf, off, ai, bi, order, n_short, min_olen, min_score)
    hints = (kd.count_long(off.cpu().numpy(), ai.cpu().numpy()),
             kd.longest_of(off.cpu().numpy()))
    _, ref, _, chosen = kernel_vs_plain(kd.block_scan, kd.plain_block_scan,
                                        args, n, hints)
    ms = {}
    for G in sorted(kd.CLUSTER_SIZES):
        out = (torch.full((n,), -7, dtype=torch.int64, device=dev),
               torch.full((n,), -7.0, dtype=torch.float64, device=dev))
        kd.block_scan(*args, *out, *hints, cluster=G)
        torch.cuda.synchronize()
        if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
            raise AssertionError(f"overlap_best_kernel at clusters of {G} "
                                 "vs plain_block_scan")
        ms[G] = cuda_ms(lambda G=G: kd.block_scan(*args, *out, *hints,
                                                  cluster=G), reps=5)
    bms = row["block"]["bound_ms"]
    log(f"overlap_best_kernel on the {row['block']['pairs']} pairs of "
        f"{row['block']['max_len']} bp at most: chosen clusters of {chosen} "
        f"{ms[chosen]:.4f} ms; " + "; ".join(
            f"G={G} {t:.4f} ms ({100 * bms / t:.2f} % of {bms:.4f} ms)"
            for G, t in ms.items())
        + f"; each equal to plain_block_scan; on {smi}")
    return dict(chosen=chosen, ms=ms, bound_ms=bms,
                pairs=row["block"]["pairs"])


def keelime_outputs(prefix):
    """The four outputs of a keelime run, the .gz files decompressed."""
    import gzip

    out = {}
    for name in ("Contig.fa.gz", "Consensus.fa.gz", "ProbabilityMatrix.tsv",
                 "CountMatrix.tsv"):
        with open(prefix + name, "rb") as f:
            data = f.read()
        out[name] = gzip.decompress(data) if name.endswith(".gz") else data
    return out


def phase_keelime(dev, out_dir, clock):
    from vgan_tpu_torch import cli
    from vgan_tpu_torch.io import gam
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.pipelines import keelime_device as kd
    from vgan_tpu_torch.utils import profiling

    db_dir, fq, d5, d3, path, hap_len = build_keelime_world(out_dir)
    smi = clock.smi

    def argv(prefix, device):
        return ["keelime", "--dbdir", db_dir, "--dbprefix", "graph.npz",
                "-fq1", fq, "-o", prefix, "-p", path, "--deam5p", d5,
                "--deam3p", d3, "--device", device, "--profile"]

    # the warm-up run keeps each overlap_best_indexed call's inputs and
    # results (find_overlaps' batch, then one a merge pass)
    indexed, calls = kd.overlap_best_indexed, []

    def keeping(*args):
        out = indexed(*args)
        if args[2].numel():  # an empty call launches nothing
            calls.append(args + (out,))
        return out

    stage_names = ("map", "analyse", "assemble", "consensus")
    profiling.enable()
    runs = []
    sw.reset_launches()
    kd.reset_launches()
    try:
        for i in range(3):  # one warm-up run, two timed
            prefix = os.path.join(out_dir, f"kl{i}_")
            profiling.PROFILER.clear()
            before = dict(sw.LAUNCHES, **kd.LAUNCHES)
            kd.overlap_best_indexed = indexed if i else keeping
            t0 = time.perf_counter()
            if cli.main(argv(prefix, str(dev))) != 0:
                raise AssertionError("cli keelime failed")
            wall = time.perf_counter() - t0
            kd.overlap_best_indexed = indexed
            # the warp kernel in find_overlaps and at least one merge
            # pass, the block kernel in at least one merge pass
            least = dict(gather_score_hash=1, overlap_warp=2, overlap_best=1)
            now = dict(sw.LAUNCHES, **kd.LAUNCHES)
            if any(now[k] < before[k] + m for k, m in least.items()):
                raise AssertionError(f"keelime run {i} launched "
                                     f"{dict(sw.LAUNCHES, **kd.LAUNCHES)}")
            outs = keelime_outputs(prefix)
            cons = outs["Consensus.fa.gz"].decode().split("\n")[1]
            called = len(cons) - cons.count("N")
            if len(cons) < 0.9 * hap_len or called < 0.8 * hap_len:
                raise AssertionError(f"keelime consensus {len(cons)} bp, "
                                     f"{called} called, of {hap_len}")
            st = {k: profiling.PROFILER.stages[k].seconds
                  for k in stage_names}
            runs.append(dict(wall_s=wall, stages_s=st, consensus_bp=len(cons),
                             called_bp=called,
                             contigs=outs["Contig.fa.gz"].count(b">")))
            log(f"keelime run {i} ({'warm-up' if i == 0 else 'timed'}): "
                f"{wall:.2f} s wall; stages {json.dumps(st)}; "
                f"{KL_READS / sum(st.values()):.0f} reads/s over "
                f"{' + '.join(stage_names)}; consensus {len(cons)} bp, "
                f"{called} called, {runs[-1]['contigs']} contigs")
    finally:
        kd.overlap_best_indexed = indexed
    launches = dict(sw.LAUNCHES, **kd.LAUNCHES)
    log(f"keelime: kernel launches in the 3 runs: {launches}")
    card = keelime_outputs(os.path.join(out_dir, "kl0_"))
    profiling.PROFILER.clear()
    t0 = time.perf_counter()
    if cli.main(argv(os.path.join(out_dir, "klcpu_"), "cpu")) != 0:
        raise AssertionError("cli keelime --device cpu failed")
    cpu_s = time.perf_counter() - t0
    cpu_st = {k: profiling.PROFILER.stages[k].seconds for k in stage_names}
    cpu = keelime_outputs(os.path.join(out_dir, "klcpu_"))
    bad = [k for k in card if card[k] != cpu[k]]
    if bad:
        raise AssertionError(f"keelime card vs cpu: {bad} differ")
    log(f"keelime --device cpu: {cpu_s:.2f} s wall; stages "
        f"{json.dumps(cpu_st)}; the four outputs equal the card's")
    overlap = check_overlap_calls(dev, calls, smi)
    # the mitogenome-length merge call with the most long pairs, at every
    # cluster size
    mito = [i for i, r in enumerate(overlap) if "block" in r
            and r["block"]["max_len"] >= MITO_FRACTION * KL_BP]
    if not mito:
        raise AssertionError("no merge pass of the warm-up run had "
                             "mitogenome-length contigs")
    k = max(mito, key=lambda k: overlap[k]["block"]["pairs"])
    sweep = cluster_sweep(dev, calls[k], overlap[k], smi)

    # map on the card and on the CPU, then duprm on the card's GAM
    recs = {}
    for d in (str(dev), "cpu"):
        out = os.path.join(out_dir, f"map_{d.replace(':', '')}.gam")
        t0 = time.perf_counter()
        if cli.main(["map", "--db", os.path.join(db_dir, "graph.npz"),
                     "-fq1", fq, "-o", out, "--device", d]) != 0:
            raise AssertionError(f"cli map --device {d} failed")
        recs[d] = (out, time.perf_counter() - t0,
                   [gam.encode_alignment(a) for a in gam.read_gam(out)])
    if recs[str(dev)][2] != recs["cpu"][2] or \
            len(recs["cpu"][2]) != KL_READS:
        raise AssertionError("map --device cuda vs cpu: alignments differ")
    dedup = os.path.join(out_dir, "dedup.gam")
    if cli.main(["duprm", recs[str(dev)][0], dedup]) != 0:
        raise AssertionError("cli duprm failed")
    kept = len(gam.read_gam(dedup))
    if not 0 < kept <= KL_READS:
        raise AssertionError(f"duprm kept {kept}")
    log(f"map: {KL_READS} alignments on the card ({recs[str(dev)][1]:.2f} s) "
        f"equal to the CPU's ({recs['cpu'][1]:.2f} s); duprm kept {kept}")
    timed = runs[1:]
    e2e = [KL_READS / sum(r["stages_s"].values()) for r in timed]
    log(f"keelime: keelime_e2e_reads_per_s "
        f"{', '.join(f'{x:.1f}' for x in e2e)} on {smi}")
    merge = overlap[1:] or overlap[:1]
    # the block kernel's pairs: contigs longer than L_WARP in merge passes
    long_merge = [r for r in merge if "block" in r]
    if not long_merge or "warp" not in overlap[0]:
        raise AssertionError("no merge pass of the warm-up run had a pair "
                             "for the block kernel, or find_overlaps none "
                             "for the warp kernel")
    return dict(launches={k: launches[k] for k in kd.LAUNCHES},
                sw_launches=launches["gather_score_hash"], runs=runs,
                reads_per_s=e2e, cpu_run_s=cpu_s, cpu_stages_s=cpu_st,
                overlap=overlap,
                find_overlaps=overlap[0],
                largest_merge=max(merge, key=lambda r: r["pairs"]),
                block_merge=max(long_merge, key=lambda r: r["block"]["pairs"]),
                cluster_sweep=sweep,
                map_card_s=recs[str(dev)][1], map_cpu_s=recs["cpu"][1],
                duprm_kept=kept)


# ----------------------------------------------------------------- phase 8
def two_rank_haplocart(dev, out_dir, world, smi):
    """`haplocart --nproc 2` as two processes on the one card (see the
    module docstring); returns the ranks' lines and the run's wall."""
    import numpy as np

    from vgan_tpu_torch.bench import free_port
    from vgan_tpu_torch.io import fastx
    from vgan_tpu_torch.parallel.multihost import shard_bounds
    from vgan_tpu_torch.pipelines import haplocart as hc
    from vgan_tpu_torch.pipelines import haplocart_device as hd
    from vgan_tpu_torch.pipelines import haplocart_runner as runner

    tsv = os.path.join(out_dir, "multi.tsv")
    vec_path = os.path.join(out_dir, "multi_vec.npy")
    port = free_port()
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "tests", "_torch_rank.py"),
         vec_path, "haplocart", "--db", world["db_dir"], "-fq1", world["fq"],
         "-o", tsv, "--device", str(dev), "--profile", "--coordinator",
         f"127.0.0.1:{port}", "--nproc", "2", "--procid", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {i} exited {p.returncode}:\n"
                                 + out[-3000:])
    ranks = sorted((json.loads(line[5:]) for out in logs
                    for line in out.splitlines() if line.startswith("RANK ")),
                   key=lambda r: r["rank"])
    if [r["rank"] for r in ranks] != [0, 1]:
        raise AssertionError(f"rank lines: {ranks}")
    for r in ranks:
        log(f"rank {r['rank']}: kernel launches {json.dumps(r['launches'])}; "
            f"{r['n_reads']} reads kept; map {r['stages_s']['map']:.3f} s, "
            f"score {r['stages_s']['score']:.3f} s on {smi}")
        for k in ("gather_score_hash", "hc_node_scores"):
            if r["launches"][k] < 1:
                raise AssertionError(f"rank {r['rank']} launched no {k} "
                                     "kernel")
    with open(tsv) as f:
        lines = f.read().splitlines()

    # the reference: each half mapped, sorted and deduplicated alone, the
    # single-process scorer on the card, the two final_vecs summed
    db, mapper = world["db"], world["mapper"]
    reads = fastx.read_fastq(world["fq"])
    want, kept = 0.0, []
    for pid in range(2):
        lo, hi = shard_bounds(len(reads), pid, 2)
        alns = [a for a in mapper.map_reads(reads[lo:hi]) if a.identity != 0]
        alns = hc.remove_duplicates(runner.gamsort(alns))
        kept.append(len(alns))
        want = want + hd.score_alignments_device(db, alns)
    got = np.load(vec_path)
    if got.shape != (N_HAPS,) or not np.isfinite(got).all():
        raise AssertionError(f"two-rank final_vec bad: shape {got.shape}")
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if rel > 1e-10:
        raise AssertionError(f"two-rank final_vec vs the shards' sum: max "
                             f"rel diff {rel:g}")
    pred = hc.predict(db, want)
    if lines != ["#sample\tpredicted haplogroup\treads",
                 f"{world['fq']}\t{pred}\t{kept[0]}"] or pred != f"hap{HAP}":
        raise AssertionError(f"two-rank TSV {lines}; want {pred}, "
                             f"{kept[0]} reads (host 0's)")
    if [r["n_reads"] for r in ranks] != kept:
        raise AssertionError(f"ranks kept {[r['n_reads'] for r in ranks]} "
                             f"reads, their halves {kept}")
    log(f"two ranks on one card: {wall:.2f} s wall for both; host 0 alone "
        f"wrote the TSV ({pred}, {kept[0]} reads); final_vec = the halves' "
        f"sum (max rel diff {rel:.3g}) on {smi}")
    return dict(wall_s=wall, ranks=ranks, rel_diff=rel, kept=kept)


def phase_multi(dev, out_dir, world, ksweep_call, smi):
    """Phase 8 (see the module docstring)."""
    import numpy as np

    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.io import fastx
    from vgan_tpu_torch.pipelines import haplocart_device as hd
    from vgan_tpu_torch.pipelines import hc_columnar

    ranks = two_rank_haplocart(dev, out_dir, world, smi)

    # HaploCart's split scorer on phase 4's deduplicated table
    db, mapper = world["db"], world["mapper"]
    table = hc_columnar.filter_sort_dedup(
        mapper.map_reads_table(fastx.read_fastq(world["fq"])))
    t0 = time.perf_counter()
    one = hc_columnar.score_table_device(db, table)
    one_s = time.perf_counter() - t0
    hd.reset_launches()
    t0 = time.perf_counter()
    split = hc_columnar.score_table_device(db, table,
                                           devices=[[dev], [dev]])
    split_s = time.perf_counter() - t0
    hc_launches = hd.LAUNCHES["hc_node_scores"]
    hc_rel = float(np.max(np.abs(split - one) / np.abs(one)))
    if hc_rel > 1e-12 or int(np.argmax(split)) != int(np.argmax(one)):
        raise AssertionError(f"split HaploCart scorer vs one card: max rel "
                             f"diff {hc_rel:g}")
    if hc_launches != 2:
        raise AssertionError(f"split HaploCart scorer launched "
                             f"{hc_launches} hc_node_scores kernels, not 2")
    log(f"split HaploCart scorer over [{dev}, {dev}]: {table.n} reads, "
        f"final_vec equal to one card's (max rel diff {hc_rel:.3g}); "
        f"{hc_launches} hc_node_scores launches; {split_s:.3f} s against "
        f"{one_s:.3f} s on {smi}")
    # the paths split over tp = 2 columns: dp = 1 x tp = 2 and 2 x 2 grids
    # of the card repeated (the support matrix's shards built by the first
    # call of each grid, then a second call timed)
    tp_grids = []
    for grid in ([[dev, dev]], [[dev, dev], [dev, dev]]):
        shape = f"{len(grid)} x {len(grid[0])}"
        hc_columnar.score_table_device(db, table, devices=grid)
        hd.reset_launches()
        t0 = time.perf_counter()
        vec = hc_columnar.score_table_device(db, table, devices=grid)
        grid_s = time.perf_counter() - t0
        n_launch = hd.LAUNCHES["hc_node_scores"]
        rel = float(np.max(np.abs(vec - one) / np.abs(one)))
        if vec.shape != one.shape or rel > 1e-12 or int(
                np.argmax(vec)) != int(np.argmax(one)):
            raise AssertionError(f"HaploCart scorer over a {shape} grid vs "
                                 f"one card: max rel diff {rel:g}")
        if n_launch != len(grid) * len(grid[0]):
            raise AssertionError(f"HaploCart scorer over a {shape} grid "
                                 f"launched {n_launch} hc_node_scores "
                                 f"kernels, not one a device")
        log(f"HaploCart scorer over a dp x tp = {shape} grid of {dev}: "
            f"final_vec ({vec.shape[0]} paths, each tp column's GEMV on "
            f"its shard of the support matrix) equal to one card's (max "
            f"rel diff {rel:.3g}), the same argmax; {n_launch} "
            f"hc_node_scores launches; {grid_s:.3f} s against {one_s:.3f} "
            f"s on {smi}")
        tp_grids.append(dict(grid=shape, rel_diff=rel, s=grid_s,
                             launches=n_launch))

    # soibean's k-sweep batch split in two halves of rows
    args, kw = ksweep_call
    kw = dict(kw, max_iter=MULTI_ITER, burn=MULTI_BURN)
    tm.reset_launches()
    t0 = time.perf_counter()
    halves = tm.run_tree_mcmc_ksweep(*args, **dict(kw, devices=[dev, dev]))
    halves_s = time.perf_counter() - t0
    launches = tm.LAUNCHES["tree_mcmc_segment"]
    tm.reset_launches()
    t0 = time.perf_counter()
    whole = tm.run_tree_mcmc_ksweep(*args, **dict(kw, devices=None))
    whole_s = time.perf_counter() - t0
    max_err = 0.0
    for a, b in zip(halves, whole):
        if not np.array_equal(a.node, b.node):
            raise AssertionError("split chains: node ids differ")
        for f in ("pos", "theta", "loglike"):
            x, y = getattr(a, f), getattr(b, f)
            if (np.abs(x - y) > 1e-10 * np.abs(y)).any():
                raise AssertionError(f"split chains: {f} past rtol 1e-10")
            max_err = max(max_err, float(np.abs(x - y).max()))
    rows = sum(s.shape[0] for s in args[3])
    if launches < 2:
        raise AssertionError(f"split chains launched {launches} kernels")
    log(f"soibean k-sweep batch ({rows} rows) split over [{dev}, {dev}], "
        f"{MULTI_ITER} steps: node ids equal to the unsplit batch, max abs "
        f"err {max_err:.3g}; {launches} tree kernel launches; {halves_s:.2f} "
        f"s against {whole_s:.2f} s on {smi}")
    return dict(ranks=ranks, hc_split=dict(rel_diff=hc_rel, split_s=split_s,
                                           one_s=one_s,
                                           launches=hc_launches),
                hc_tp=tp_grids,
                chains=dict(launches=launches, max_abs_err=max_err,
                            split_s=halves_s, one_s=whole_s))


# ----------------------------------------------------------------- phase 9
# the kernels the bench's phases launch (see the module docstring)
BENCH_KERNELS = ("sw_scores", "gather_score_hash", "hc_node_scores",
                 "euka_score", "abundance_mcmc_segment", "tree_mcmc_segment",
                 "overlap_warp", "overlap_best")
BENCH_FLAGS = ("argmax_agrees", "hc_realdb_argmax_agrees",
               "device_argmax_agrees")
# the names the bench's line adds to bench.FIELD_ORDER's
BENCH_ADDED = ("sw_bound_share", "card", "host_cpus", "worlds")


def _positive_numbers(x) -> bool:
    """Every number in x (a number, or a list or dict of them) finite
    and above 0."""
    if isinstance(x, dict):
        return all(_positive_numbers(v) for v in x.values())
    if isinstance(x, list):
        return len(x) > 0 and all(_positive_numbers(v) for v in x)
    import math

    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and math.isfinite(x) and x > 0)


def check_bench_result(res):
    """Every name of bench.FIELD_ORDER and of BENCH_ADDED in the line,
    the three agreement flags true and every metric finite and above 0
    (the text fields, the card and the worlds aside)."""
    from vgan_tpu_torch import bench

    missing = [k for k in bench.FIELD_ORDER + list(BENCH_ADDED)
               if k not in res]
    if missing:
        raise AssertionError(f"bench: no {', '.join(missing)} in its line")
    bad = [k for k in BENCH_FLAGS if res[k] is not True]
    bad += [k for k, v in res.items()
            if k not in BENCH_FLAGS + ("metric", "unit", "workload", "card",
                                       "worlds")
            and not _positive_numbers(v)]
    if bad:
        raise AssertionError("bench: " + ", ".join(
            f"{k}={res[k]!r}" for k in bad))


class BenchCalls:
    """Keeps kernel wrappers' calls made inside the bench's phases, as
    the other phases keep theirs: while in use, each wrapper of `specs`
    = {key: (module, wrapper name, bench phase, pick)} is wrapped so
    that a call made while `b` runs that phase, for which pick(args,
    kept) (kept: the calls of that key so far) returns the arguments to
    keep, is appended to calls[key] as (those arguments, kwargs, the
    wrapper's output). pick runs before the wrapper, so it can clone
    what the wrapper updates in place."""

    def __init__(self, b, specs):
        self.b, self.specs = b, specs
        self.calls = {k: [] for k in specs}
        self.saved = []

    def __enter__(self):
        for key, (mod, name, phase, pick) in self.specs.items():
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def keeping(*args, _fn=fn, _key=key, _phase=phase, _pick=pick,
                        **kw):
                kept = (_pick(args, self.calls[_key])
                        if self.b.phase == _phase else None)
                out = _fn(*args, **kw)
                if kept is not None:
                    self.calls[_key].append((kept, kw, out))
                return out

            setattr(mod, name, keeping)
        return self.calls

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def bench_hc_step(call, smi):
    """hc_node_scores_kernel at the device_step phase's call (`call`:
    its HcBatch of M rows, S = 8, its f64 tables of the real DB's shape,
    bep and consensus): kernel vs plain (final scores to rtol 1e-12),
    the kernel by events and on the device alone, the plain version, the
    GEMV and the whole score_batch call, beside the bound of the node scores (its f64
    instructions against every batch column, the tables it reads and c
    written once) and the GEMV's bytes."""
    import torch

    from vgan_tpu_torch.pipelines import haplocart_device as hd

    batch, t, bep, consensus = call
    M, S = batch.g.shape
    c, sb = hd.node_scores(batch, t, bep, consensus)
    pc, psb = hd.node_scores_plain(batch, t, bep, consensus)
    err = _close("bench device_step: score_batch kernel vs plain",
                 sb + c @ t.support, psb + pc @ t.support, 1e-12)
    ms = cuda_ms(lambda: hd.node_scores(batch, t, bep, consensus), reps=20)
    dev_ms = queued_ms(lambda: hd.node_scores(batch, t, bep, consensus), 20)
    plain_ms = cuda_ms(lambda: hd.node_scores_plain(batch, t, bep,
                                                    consensus), reps=3)
    gemv_ms = cuda_ms(lambda: c @ t.support, reps=20)
    call_ms = cuda_ms(lambda: hd.score_batch(batch, t, bep, consensus),
                      reps=20)
    counted = batch.valid & (batch.g < 4) & (batch.r < 4)
    n_pos = int(counted.sum())
    ops = HC_F64_OPS_PER_POSITION * n_pos + HC_F64_OPS_PER_ROW * M
    tables = [t.match_tab, t.mapp_tab, t.imtab, t.bg]
    if bool(counted[~batch.use_bep].any()):
        tables.append(t.qtab)
    moved = (nbytes(batch.g, batch.r, batch.q, batch.pang, batch.mq,
                    batch.b, batch.node, batch.valid, batch.use_bep)
             + nbytes(*tables) + 8 * (t.support.shape[0] + 1))
    bms, by = f64_bound_ms(ops, moved)
    gemv_bound = nbytes(t.support, c) / HBM_BYTES_PER_S * 1e3
    dev_txt = ("not measured" if dev_ms is None else
               f"{dev_ms:.4f} ms ({100 * bms / dev_ms:.1f} %)")
    log(f"bench hc_node_scores_kernel, device_step (M={M}, S={S}, "
        f"{t.support.shape[0]} x {t.support.shape[1]} f64 support): "
        f"{ms:.4f} ms a call by events ({100 * bms / ms:.1f} % of the "
        f"{bms:.5f} ms bound, {by}), on the device alone {dev_txt}; plain "
        f"{plain_ms:.3f} ms; the GEMV {gemv_ms:.4f} ms (bytes bound "
        f"{gemv_bound:.4f} ms); score_batch {call_ms:.4f} ms; equal to plain "
        f"(max abs err {err:.3g}); on {smi}")
    return dict(M=M, S=S, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, gemv_ms=gemv_ms,
                gemv_bound_ms=gemv_bound, call_ms=call_ms, max_abs_err=err)


def bench_chain(call, smi):
    """abundance_mcmc_segment_kernel at the euka_mcmc phase's segment (T =
    6): kernel vs plain (rtol 1e-12, the same accepted steps), timed by
    events beside its bound; the plain version once."""
    from vgan_tpu_torch.infer import abundance_mcmc as am

    args, kw, _out = call
    S, T = args[2].shape
    (ks, kl), kp = am.run_segment(*args, **kw)
    (ps, pl), pp = am.run_segment_plain(*args)
    err = max(_close("bench chain proposals", kp, pp, 1e-12),
              _close("bench chain state", ks, ps, 1e-12),
              _close("bench chain likelihood", kl, pl, 1e-12))
    steps, _margin = same_accepts("bench chain", args, kp, pp)
    ms = cuda_ms(lambda: am.run_segment(*args, **kw), reps=5)
    plain_ms = cuda_ms(lambda: am.run_segment_plain(*args), reps=1,
                       warmup=0)
    bms, by = f64_bound_ms(S * (AM_F64_OPS_PER_TAXON * T
                                + AM_F64_OPS_PER_STEP), 2 * S * T * 8)
    log(f"bench abundance chain kernel, euka_mcmc (T={T}, S={S}): "
        f"{ms:.4f} ms = {1e3 * ms / S:.4f} us a step ({100 * bms / ms:.3f} "
        f"% of the {bms:.5f} ms bound, {by}); acceptance "
        f"{len(steps) / S:.4f}; plain {plain_ms:.1f} ms; equal to plain "
        f"(max abs err {err:.3g}); on {smi}")
    return dict(T=T, S=S, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, acceptance=len(steps) / S, max_abs_err=err)


def bench_tree(call, smi):
    """tree_mcmc_segment_kernel over SB_TIMED_STEPS steps of the
    soibean_mcmc phase's first post-burn-in segment (4 chains of k = 2
    sources, R = 200 reads, 255 nodes) from that segment's carry: kernel
    vs plain (node ids exact, floats to rtol 1e-10), timed by events
    beside tree_bound_ms; the plain version once."""
    import torch

    from vgan_tpu_torch.infer import tree_mcmc as tm

    args, _kw, _out = call
    carry, rest = args[:4], args[4:]
    mask, iters, sd, noise = rest[:4]
    data = rest[4:]  # path_map_t, counts25_t, tree, con, freq
    n = min(SB_TIMED_STEPS, int(iters.shape[0]))
    seg = (mask, iters[:n].contiguous(), sd[:n].contiguous(),
           tm.Noise(*(x[:, :n].contiguous() for x in noise)))
    _kc, krec = tm.run_segment(*(x.clone() for x in carry), *seg, *data)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _pc, prec = tm.run_segment_plain(*(x.clone() for x in carry), *seg,
                                     *data)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    if not torch.equal(krec[0], prec[0]):
        raise AssertionError("bench tree kernel vs plain: node ids differ")
    err = max(_close(f"bench tree kernel vs plain ({name})", x, y, 1e-10)
              for name, x, y in zip(("pos", "theta", "loglike"), krec[1:],
                                    prec[1:]))
    ms = cuda_ms(lambda: tm.run_segment(*(x.clone() for x in carry), *seg,
                                        *data), reps=5)
    B, K = mask.shape
    P, R = data[0].shape
    hops = noise.walk_u.shape[3]
    bms, by, _stream = tree_bound_ms(
        mask.cpu().numpy(), n, R, dict(P=P, size=data[1].element_size()),
        hops)
    log(f"bench tree kernel, soibean_mcmc (B={B}, K={K}, R={R}, P={P}, "
        f"{hops} hops, from iteration {int(iters[0])}): {ms:.3f} ms for {n} "
        f"steps = {1e3 * ms / n:.2f} us a step ({100 * bms / ms:.2f} % of "
        f"the {bms:.4f} ms bound, {by}); plain {plain_ms:.1f} ms; equal to "
        f"plain (max abs err {err:.3g}); on {smi}")
    return dict(B=B, K=K, R=R, P=P, steps=n, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, max_abs_err=err)


def bench_euka(calls, smi):
    """euka_score_kernel at the euka_realdb phase's calls (its world's
    100-bp reads): each call's outputs against score_batch_plain on the
    card (rtol 1e-12, NaN and inf where the plain version has them), and
    the largest call timed (time_euka_call)."""
    from vgan_tpu_torch.pipelines import euka as ek

    err = 0.0
    for i, (args, _kw, got) in enumerate(calls):
        want = ek.score_batch_plain(*args)
        err = max(err, _close(f"bench euka_realdb call {i} il", got[0],
                              want[0], 1e-12),
                  _close(f"bench euka_realdb call {i} nl", got[1], want[1],
                         1e-12))
    args, _kw, got = max(calls, key=lambda c: c[0][0].numel())
    row = time_euka_call("bench euka_realdb, its largest scorer call", args,
                         got, smi)
    log(f"bench euka_realdb: {len(calls)} scorer calls equal to plain (max "
        f"abs err {err:.3g})")
    return dict(row, calls=len(calls), max_abs_err=max(err,
                                                       row["max_abs_err"]))


def bench_overlaps(dev, calls, smi):
    """The two overlap kernels at the keelime phase's calls (the contigs
    of the 32-haplotype toy world): each overlap_best_indexed call's
    lengths and scores equal to plain_indexed's on the card, then the
    call with the most short pairs and the one with the most long pairs
    (the warp and the block kernel's largest batches) checked and timed
    as phase 7 checks its calls (check_overlap_calls). Returns (warp
    row, block row, calls)."""
    import torch

    from vgan_tpu_torch.pipelines import keelime_device as kd

    n_short = []
    for i, (args, _kw, got) in enumerate(calls):
        buf, off, ai, bi, min_olen, min_score = args[:6]
        want = kd.plain_indexed(kd.seq_codes(buf), off, ai, bi, min_olen,
                                min_score)
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"bench keelime overlap call {i}: kernels "
                                 "vs plain_indexed")
        la = off[ai.long() + 1] - off[ai.long()]
        n_short.append(int(kd.split_by_length(la)[1]))
    n_long = [c[0][2].numel() - k for c, k in zip(calls, n_short)]
    if max(n_long) == 0:
        raise AssertionError("bench keelime: no call has a long pair")
    picked = sorted({max(range(len(calls)), key=n_short.__getitem__),
                     max(range(len(calls)), key=n_long.__getitem__)})
    rows = check_overlap_calls(dev, [c[0] + (c[2],) for c in
                                     (calls[i] for i in picked)], smi)
    warp = max((r["warp"] for r in rows if "warp" in r),
               key=lambda c: c["pairs"])
    block = max((r["block"] for r in rows if "block" in r),
                key=lambda c: c["pairs"])
    log(f"bench keelime: {len(calls)} overlap calls equal to plain; calls "
        f"{picked} checked and timed; on {smi}")
    return dict(warp, calls=len(calls)), dict(block, calls=len(calls))


def phase_bench(dev, clock, realdb):
    """Phase 9: the port's bench at full size, in this process, on phase
    4's real-DB world (`realdb`: its graph and mapper; see the module
    docstring). Returns its result line, the launches of each kernel
    during it, and each kernel's row at the bench's shape."""
    import torch

    from vgan_tpu_torch import bench
    from vgan_tpu_torch.infer import abundance_mcmc as am
    from vgan_tpu_torch.infer import tree_mcmc as tm
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.pipelines import euka as ek
    from vgan_tpu_torch.pipelines import haplocart_device as hd
    from vgan_tpu_torch.pipelines import keelime_device as kd

    sizes = bench.Sizes.of(False)
    b = bench.Bench(dev, sizes, realdb=realdb)
    burn = sizes.soibean_burn

    def first_post_burn_in(args, kept):
        # soibean_mcmc's first post-burn-in segment (of its warm run),
        # its carry cloned before the kernel updates it in place
        if kept or int(args[5][0]) != burn + 1:
            return None
        return tuple(x.clone() for x in args[:4]) + args[4:]

    specs = {
        # realdb_mapping's first call (the warm-up's 4,096-read chunk)
        "gsh": (sw, "gather_score_hash", "realdb_mapping",
                lambda args, kept: None if kept else args),
        "euka": (ek, "score_batch", "euka_realdb", lambda args, kept: args),
        "overlap": (kd, "overlap_best_indexed", "keelime",
                    lambda args, kept: args if args[2].numel() else None),
        "chain": (am, "run_segment", "euka_mcmc", lambda args, kept: args),
        "tree": (tm, "run_segment", "soibean_mcmc", first_post_burn_in),
    }
    mods = (sw, hd, ek, am, tm, kd)
    for m in mods:
        m.reset_launches()
    t0 = time.perf_counter()
    with BenchCalls(b, specs) as calls:
        fields = bench.run(b, list(bench.PHASES))
    wall = time.perf_counter() - t0
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    res = bench.result(fields, b)
    print("bench " + json.dumps(res), flush=True)
    log(f"bench: {wall:.1f} s for all {len(bench.PHASES)} phases; kernel "
        f"launches {json.dumps(launches)}; kept calls "
        f"{json.dumps({k: len(v) for k, v in calls.items()})}; on "
        f"{clock.smi}")
    check_bench_result(res)
    missing = [k for k in BENCH_KERNELS if launches[k] < 1]
    missing += [k for k, v in calls.items() if not v]
    if missing:
        raise AssertionError(f"bench: no launch of {missing}")

    # the sw phase's last scores against the plain version, and the SW
    # kernel timed at its shape
    args, out = b.sw_call
    if not torch.equal(out, sw.sw_scores_plain(*args)):
        raise AssertionError("bench sw phase: scores != sw_scores_plain")
    B, R, W = sizes.sw_shape
    t_sw = clock.timed(f"bench sw phase's shape (B={B}, R={R}, W={W}, "
                       "full-length)", lambda: sw.sw_scores(*args),
                       lambda: sw.sw_scores_plain(*args), sw_work(*args),
                       reps=sizes.sw_reps)
    gsh = check_sw_calls("bench realdb_mapping",
                         [(a, o) for a, _kw, o in calls["gsh"]], clock)
    # device_step's inputs, built as the phase builds them, and
    # score_batch's default bep and consensus, as the phase calls it
    _support, t, batch = bench.device_step_inputs(dev, sizes.n_reads_dev)
    hc_step = bench_hc_step((batch, t, 1e-4, False), clock.smi)
    del t, batch
    warp, block = bench_overlaps(dev, calls["overlap"], clock.smi)
    return dict(result=res, wall_s=wall, launches=launches, sw=t_sw,
                gsh=dict(gsh["calls"][0], max_abs_err=gsh["max_abs_err"]),
                hc_step=hc_step, euka=bench_euka(calls["euka"], clock.smi),
                warp=warp, block=block,
                chain=bench_chain(calls["chain"][-1], clock.smi),
                tree=bench_tree(calls["tree"][0], clock.smi))


# ----------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    name, smi = phase_device()
    builds, sass = phase_build()
    clock = Clock(smi)
    k = phase_kernels(dev, clock)
    # phases 6, 7 and 8 run before phase 5, whose torch.profiler pass
    # slows every later launch of the process; phase 4's world stays for
    # phase 8
    with tempfile.TemporaryDirectory(prefix="vgan_smoke_") as hc_tmp:
        e2e = phase_e2e(dev, hc_tmp, clock)
        log(f"e2e: {', '.join(f'{x:.0f}' for x in e2e['reads_per_s'])} "
            f"reads/s (map+score, {N_READS} reads, {N_HAPS} paths) on {smi}")
        with tempfile.TemporaryDirectory(prefix="vgan_smoke_soibean_") as tmp:
            sb = phase_soibean(dev, tmp, clock)
        sb["patristic"] = check_patristic(dev, smi)
        with tempfile.TemporaryDirectory(prefix="vgan_smoke_keelime_") as tmp:
            kl = phase_keelime(dev, tmp, clock)
        t8 = time.perf_counter()
        world = e2e.pop("world")
        mp = phase_multi(dev, hc_tmp, world, sb.pop("ksweep_call"), smi)
        log(f"phase 8: {time.perf_counter() - t8:.1f} s on {smi}")
    t9 = time.perf_counter()
    bn = phase_bench(dev, clock, (world["db"].graph, world["mapper"]))
    del world
    log(f"phase 9: {time.perf_counter() - t9:.1f} s on {smi}")
    with tempfile.TemporaryDirectory(prefix="vgan_smoke_euka_") as tmp:
        eu = phase_euka(dev, tmp, clock)
    log(f"euka: euka_realdb_e2e_reads_per_s "
        f"{', '.join(f'{x:.0f}' for x in eu['reads_per_s'])}; "
        f"euka_mcmc_iters_per_s "
        f"{', '.join(f'{x:.0f}' for x in eu['mcmc_iters_per_s'])} "
        f"({EUKA_TAXA} taxa) on {smi}")
    log("summary " + json.dumps(dict(
        card=smi, builds_s=builds, sass=sass, kernels=k,
        haplocart_sw_calls=e2e["sw"], object_path=e2e["object_path"],
        haplocart_likelihood_step=e2e["hc_step"], euka_chain=eu["chain"],
        euka_scorer=eu["scorer"],
        e2e_reads_per_s=e2e["reads_per_s"],
        e2e_cli_wall_s=e2e["cli_wall_s"],
        mapper_stage_s=[r["stages"] for r in e2e["runs"]],
        euka_realdb_e2e_reads_per_s=eu["reads_per_s"],
        euka_mcmc_iters_per_s=eu["mcmc_iters_per_s"],
        euka_cli_wall_s=eu["cli_wall_s"],
        euka_mapper_stage_s=[r["stages"] for r in eu["runs"]],
        euka_card_vs_cpu=eu["compare"], euka_profile=eu["profile"],
        soibean_e2e_reads_per_s=sb["reads_per_s"],
        soibean_mcmc_iters_per_s=sb["mcmc_iters_per_s"],
        soibean_sampler_iters_per_s=sb["sampler_iters_per_s"],
        soibean_runs=sb["runs"], soibean_tree_kernel=sb["kernel"],
        soibean_sw_calls=sb["sw"], soibean_patristic=sb["patristic"],
        keelime_e2e_reads_per_s=kl["reads_per_s"], keelime_runs=kl["runs"],
        keelime_cpu_run_s=kl["cpu_run_s"],
        keelime_cpu_stages_s=kl["cpu_stages_s"],
        keelime_overlap_calls=kl["overlap"],
        keelime_cluster_sweep=kl["cluster_sweep"],
        keelime_map_card_s=kl["map_card_s"], keelime_map_cpu_s=kl["map_cpu_s"],
        keelime_duprm_kept=kl["duprm_kept"], multi=mp,
        bench={k: bn[k] for k in ("wall_s", "launches", "sw", "gsh",
                                  "hc_step", "euka", "warp", "block",
                                  "chain", "tree")})))
    # launches: sw_scores from the mapper's object path, gather_score_hash
    # from the HaploCart, soibean, keelime and euka CLI runs and phase 8's
    # two ranks, tree_mcmc_segment from the soibean CLI runs and phase 8's
    # split chains, the two overlap kernels from the keelime CLI runs,
    # abundance_mcmc_segment and euka_score from the euka CLI runs,
    # hc_node_scores from the HaploCart CLI runs, phase 8's two ranks, its
    # split scorer and its tp grids (each counted from 0 just before its
    # runs); times and bounds at the
    # timing shape, at the mapper's pool batch, over SB_TIMED_STEPS
    # post-burn-in steps of the soibean k-sweep batch, at the find_overlaps
    # batch of the keelime warm-up run (warp), at the long pairs of the
    # largest merge batch with some (block), over the euka warm-up run's
    # segment (chain) and at the HaploCart warm-up run's largest
    # likelihood step
    t_sw, t_gsh, t_tree = k["sw"], k["gsh"]["pool"], sb["kernel"]["post"]
    # the likelihood step at its largest call of the HaploCart warm-up run
    t_hc = max(e2e["hc_step"]["calls"], key=lambda c: c["M"] * c["S"])
    t_am = eu["chain"]
    # euka's scorer at the largest call of its warm-up run
    t_eu = max(eu["scorer"]["calls"], key=lambda c: c["B"] * c["L"])
    t_warp = kl["find_overlaps"]["warp"]
    t_block = kl["block_merge"]["block"]
    t_mito = kl["cluster_sweep"]
    t_pt = sb["patristic"]
    log(f"smoke total {time.perf_counter() - START:.0f} s on {smi}")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "sw_scores_kernel",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": (e2e["object_path"]["launches"]
                     + bn["launches"]["sw_scores"]),
        "max_abs_err": max(k["max_abs_err"]["sw_scores"],
                           e2e["object_path"]["max_abs_err"]),
        "bench_shape": bn["sw"],
        "ms": t_sw["ms"],
        "plain_ms": t_sw["plain_ms"],
        "bound_ms": t_sw["bound_ms"],
        "bound_by": t_sw["bound_by"],
        "library_ms": None,
    }, {
        "name": "gather_score_hash_kernel",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": (e2e["launches"]["gather_score_hash"]
                     + sb["sw_launches"] + kl["sw_launches"]
                     + eu["launches"]["gather_score_hash"]
                     + sum(r["launches"]["gather_score_hash"]
                           for r in mp["ranks"]["ranks"])
                     + bn["launches"]["gather_score_hash"]),
        "max_abs_err": max(k["max_abs_err"]["gather_score_hash"],
                           e2e["sw"]["max_abs_err"],
                           sb["sw"]["max_abs_err"],
                           eu["compare"]["sw"]["max_abs_err"],
                           bn["gsh"]["max_abs_err"]),
        "bench_shape": bn["gsh"],
        "ms": t_gsh["ms"],
        "plain_ms": t_gsh["plain_ms"],
        "bound_ms": t_gsh["bound_ms"],
        "bound_by": t_gsh["bound_by"],
        "library_ms": None,
    }, {
        "name": "tree_mcmc_segment_kernel",
        "route": "cuda",
        "source": TREE_SOURCE,
        "replaces": TREE_REPLACES,
        "launches": (sb["launches"] + mp["chains"]["launches"]
                     + bn["launches"]["tree_mcmc_segment"]),
        "max_abs_err": max(sb["kernel"]["max_abs_err"],
                           bn["tree"]["max_abs_err"]),
        "bench_shape": bn["tree"],
        "ms": t_tree["ms"],
        "plain_ms": t_tree["plain_ms"],
        "bound_ms": t_tree["bound_ms"],
        "bound_by": t_tree["bound_by"],
        "library_ms": None,
    }, {
        "name": "overlap_warp_kernel",
        "route": "cuda",
        "source": KL_SOURCE,
        "replaces": KL_REPLACES,
        "launches": (kl["launches"]["overlap_warp"]
                     + bn["launches"]["overlap_warp"]),
        "max_abs_err": max([r["warp"]["max_abs_err"] for r in kl["overlap"]
                            if "warp" in r] + [bn["warp"]["max_abs_err"]]),
        "bench_shape": bn["warp"],
        "ms": t_warp["ms"],
        "plain_ms": t_warp["plain_ms"],
        "bound_ms": t_warp["bound_ms"],
        "bound_by": t_warp["bound_by"],
        "library_ms": t_warp["library_ms"],
    }, {
        "name": "overlap_best_kernel",
        "route": "cuda",
        "source": KL_SOURCE,
        "replaces": KL_REPLACES,
        "launches": (kl["launches"]["overlap_best"]
                     + bn["launches"]["overlap_best"]),
        "max_abs_err": max([r["block"]["max_abs_err"]
                            for r in kl["overlap"] if "block" in r]
                           + [bn["block"]["max_abs_err"]]),
        "bench_shape": bn["block"],
        "ms": t_block["ms"],
        "plain_ms": t_block["plain_ms"],
        "bound_ms": t_block["bound_ms"],
        "bound_by": t_block["bound_by"],
        "library_ms": t_block["library_ms"],
        "cluster": t_block["cluster"],
        "mito_pairs": t_mito["pairs"],
        "mito_cluster": t_mito["chosen"],
        "mito_ms": t_mito["ms"][t_mito["chosen"]],
        "mito_bound_ms": t_mito["bound_ms"],
        "mito_ms_by_cluster": t_mito["ms"],
    }, {
        "name": "abundance_mcmc_segment_kernel",
        "route": "cuda",
        "source": AM_SOURCE,
        "replaces": AM_REPLACES,
        "launches": (eu["launches"]["abundance_mcmc_segment"]
                     + bn["launches"]["abundance_mcmc_segment"]),
        "max_abs_err": max(t_am["max_abs_err"], bn["chain"]["max_abs_err"]),
        "ms": t_am["ms"],
        "plain_ms": t_am["plain_ms"],
        "bound_ms": t_am["bound_ms"],
        "bound_by": t_am["bound_by"],
        "library_ms": t_am["graph_ms"],
        "bench_shape": bn["chain"],
        "steps": t_am["S"],
        "taxa": t_am["T"],
        "floor_ms": t_am["floor_ms"],
        "window": t_am["window"],
        "acceptance": t_am["acceptance"],
        "steps_a_round": t_am["steps_a_round"],
        "high_acceptance_us_a_step": t_am["high"]["us_a_step"],
        "us_a_step_by_window": {
            label: {str(r["d"]): r["us_a_step"] for r in sw["by_warps"]}
            for label, sw in t_am["sweep"].items()},
    }, {
        "name": "hc_node_scores_kernel",
        "route": "cuda",
        "source": HC_SOURCE,
        "replaces": HC_REPLACES,
        "launches": (e2e["launches"]["hc_node_scores"]
                     + sum(r["launches"]["hc_node_scores"]
                           for r in mp["ranks"]["ranks"])
                     + mp["hc_split"]["launches"]
                     + sum(g["launches"] for g in mp["hc_tp"])
                     + bn["launches"]["hc_node_scores"]),
        "max_abs_err": max(e2e["hc_step"]["max_abs_err"],
                           bn["hc_step"]["max_abs_err"]),
        "ms": t_hc["ms"],
        "plain_ms": t_hc["plain_ms"],
        "bound_ms": t_hc["bound_ms"],
        "bound_by": t_hc["bound_by"],
        "library_ms": None,
        "bench_shape": bn["hc_step"],
        "M": t_hc["M"],
        "S": t_hc["S"],
        "call_ms": t_hc["call_ms"],
        "device_ms": t_hc["device_ms"],
        "phase_share": dict(zip(HC_PHASES, t_hc["phase_share"])),
    }, {
        "name": "euka_score_kernel",
        "route": "cuda",
        "source": EUKA_SOURCE,
        "replaces": EUKA_REPLACES,
        "launches": (eu["launches"]["euka_score"]
                     + bn["launches"]["euka_score"]),
        "max_abs_err": max(eu["scorer"]["max_abs_err"],
                           bn["euka"]["max_abs_err"]),
        "bench_shape": bn["euka"],
        "ms": t_eu["ms"],
        "plain_ms": t_eu["plain_ms"],
        "bound_ms": t_eu["bound_ms"],
        "bound_by": t_eu["bound_by"],
        "library_ms": t_eu["graph_ms"],
        "B": t_eu["B"],
        "L": t_eu["L"],
        "device_ms": t_eu["device_ms"],
        "calls_ms": [c["ms"] for c in eu["scorer"]["calls"]],
        "calls_device_ms": [c["device_ms"] for c in eu["scorer"]["calls"]],
        "share_of_map_score": eu["scorer"]["share_of_map_score"],
        "config": t_eu["config"],
        "phase_split": t_eu["phase_split"],
        **{key: {k: eu["scorer"][src][k] for k in (
            "B", "L", "ms", "device_ms", "plain_ms", "graph_ms", "bound_ms",
            "bound_by", "config", "phase_split")}
           for key, src in (("long_1000bp", "long"),
                            ("long_1000bp_both_orientations", "long_both"))},
    }, {
        "name": "patristic_series_kernel",
        "route": "cuda",
        "source": PT_SOURCE,
        "replaces": None,
        "launches": sb["patristic_launches"],
        "max_abs_err": t_pt["max_abs_err"],
        "ms": t_pt["ms"],
        "plain_ms": t_pt["plain_ms"],
        "bound_ms": t_pt["bound_ms"],
        "bound_by": t_pt["bound_by"],
        "library_ms": None,
        "device_ms": t_pt["device_ms"],
        "call_ms": t_pt["call_ms"],
        "held_ms": t_pt["held_ms"],
        "states": t_pt["states"],
        "leaves": t_pt["leaves"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
