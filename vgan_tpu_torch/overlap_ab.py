"""Times this checkout's overlap scans (csrc/keelime.cu) against another
build, for example a parent commit's keelime.cu unpacked with
`git archive`, on chip_smoke.py's keelime world: every
overlap_best_indexed call of a short `keelime --device cuda` run.

    python -m vgan_tpu_torch.overlap_ab OTHER_KEELIME_CU
        [--e2e OTHER_CHECKOUT]

The other source may have this checkout's C interface (the long class
launched as clusters of G CTAs, a pair table) or the one before it (one
128-thread block a long pair, the [16, 16] int32 doubled table, no G),
which is launched through its own entry points on the same split. Both
libraries are built at once. Each call goes once through both (the
results must be equal); then, in the order this, other, other, this and
with CUDA events over 5 calls each: the whole call (the split and the
kernels it launches) on find_overlaps' batch, the largest merge batch
and every merge call with long pairs; and the block kernel alone on the
long class of each of those merge calls (this checkout's at the cluster
size it chooses, printed beside it). With --e2e, keelime end to end on
the same world from this checkout and from another (for example the
parent commit unpacked with `git archive`): a fresh `python -m
vgan_tpu_torch.cli keelime --device cuda --profile` process a run, one
warm-up run each (it also builds that checkout's libraries), then
E2E_RUNS runs a turn in the order this, other, other, this:
keelime_e2e_reads_per_s (reads over map + analyse + assemble +
consensus) and the assemble stage. Run it from the root of a checkout
on a machine with an NVIDIA GPU and nvcc. Each line names the card and
its power limit.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile
import threading

from . import _native

REPO = os.path.dirname(_native._PKG_DIR)


def _load_other(path):
    """(library, "cluster" or "block"): the keelime.cu at `path` built as a
    second library (its own name in _build/), typed as this checkout's
    interface or as the one-block-a-pair interface before it."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = _native._find_tool("nvcc",
                              [os.path.join(cuda_home, "bin", "nvcc")])
    ours = threading.Thread(target=_native.keelime_lib)  # both at once
    ours.start()
    lib = ctypes.CDLL(_native._build("vgan_keelime_other", nvcc,
                                     _native.NVCC_FLAGS, [path], []))
    ours.join()
    if hasattr(lib, "overlap_best_max_active_clusters"):
        _native._type_keelime(lib)
        return lib, "cluster"
    vp, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_double)
    for fn in (lib.overlap_warp_launch, lib.overlap_best_launch):
        fn.restype = i32
        fn.argtypes = [
            vp, vp, vp, vp,        # seq, off [S + 1], ai, bi
            vp, vp, i64,           # order [n] int32, n_short [1] int32, n
            vp, vp,                # lut [256] uint8, table2 [16, 16]
            i64, f64,              # min_olen, min_score
            vp, vp,                # out_len, out_score
            vp,                    # stream
        ]
    return lib, "block"


def keelime_calls(dev, out_dir):
    """Every overlap_best_indexed call of a keelime run on chip_smoke.py's
    keelime world: [(seq_buf, seq_off, ai, bi, min_olen, min_score,
    longest, n_long)]."""
    import chip_smoke as cs
    from .cli import main as cli_main
    from .pipelines import keelime_device as kd

    db_dir, fq, d5, d3, path, _ = cs.build_keelime_world(out_dir)
    indexed, calls = kd.overlap_best_indexed, []

    def keeping(*args):
        calls.append(args)
        return indexed(*args)

    kd.overlap_best_indexed = keeping
    try:
        if cli_main(["keelime", "--dbdir", db_dir, "--dbprefix",
                     "graph.npz", "-fq1", fq, "-o",
                     os.path.join(out_dir, "kl_"), "-p", path, "--deam5p",
                     d5, "--deam3p", d3, "--device", str(dev)]) != 0:
            raise RuntimeError("cli keelime failed")
    finally:
        kd.overlap_best_indexed = indexed
    return calls


def host_hints(call):
    """(n_long, longest) of a call, from its table and indices on the
    host: block_scan's hints."""
    from .pipelines import keelime_device as kd

    off, ai = (t.cpu().numpy() for t in (call[1], call[2]))
    return kd.count_long(off, ai), kd.longest_of(off)


def other_runs(lib, kind, call):
    """(the whole call, the block kernel alone on the long class) of the
    other library on one call, each a function giving (out_len,
    out_score)."""
    import torch

    from .pipelines import keelime_device as kd

    seq_buf, seq_off, ai, bi, min_olen, min_score = call[:6]
    dev = seq_buf.device
    ours = _native.keelime_lib()

    def swapped(fn):
        def run(*args, **kw):
            _native._loaded["keelime"] = lib
            try:
                return fn(*args, **kw)
            finally:
                _native._loaded["keelime"] = ours
        return run

    order, n_short = kd.split_by_length(
        seq_off[ai.long() + 1] - seq_off[ai.long()])
    n = ai.numel()
    hints = host_hints(call)

    def outs():
        return (torch.empty(n, dtype=torch.int64, device=dev),
                torch.empty(n, dtype=torch.float64, device=dev))

    if kind == "cluster":
        def alone():
            out = outs()
            swapped(kd.block_scan)(seq_buf, seq_off, ai, bi, order, n_short,
                                   min_olen, min_score, *out, *hints)
            return out
        return lambda: swapped(kd.overlap_best_indexed)(*call), alone

    lut, t2 = (torch.from_numpy(x.reshape(-1)).to(dev)
               for x in kd.code_tables())
    t2_i8 = t2.to(torch.int8)

    def launch(fn, table, order, n_short, out):
        rc = fn(seq_buf.data_ptr(), seq_off.data_ptr(), ai.data_ptr(),
                bi.data_ptr(), order.data_ptr(), n_short.data_ptr(), n,
                lut.data_ptr(), table.data_ptr(), int(min_olen),
                float(min_score), out[0].data_ptr(), out[1].data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"other library's launch: CUDA error {rc}")

    def whole():
        out = outs()
        o, ns = kd.split_by_length(seq_off[ai.long() + 1]
                                   - seq_off[ai.long()])
        launch(lib.overlap_warp_launch, t2_i8, o, ns, out)
        if call[6] is None or call[6] > kd.L_WARP:
            launch(lib.overlap_best_launch, t2, o, ns, out)
        return out

    def alone():
        out = outs()
        launch(lib.overlap_best_launch, t2, order, n_short, out)
        return out

    return whole, alone


STAGES = ("map", "analyse", "assemble", "consensus")
E2E_RUNS = 3  # runs a turn of --e2e's this, other, other, this


def e2e(other_repo, smi):
    """keelime_e2e_reads_per_s and the assemble stage of this checkout and
    `other_repo`, a fresh CLI process a run (see the module docstring)."""
    import chip_smoke as cs

    with tempfile.TemporaryDirectory(prefix="vgan_overlap_e2e_") as tmp:
        db_dir, fq, d5, d3, path, _ = cs.build_keelime_world(tmp)

        def run(repo):
            r = subprocess.run(
                [sys.executable, "-m", "vgan_tpu_torch.cli", "keelime",
                 "--dbdir", db_dir, "--dbprefix", "graph.npz", "-fq1", fq,
                 "-o", os.path.join(tmp, "kl_"), "-p", path, "--deam5p", d5,
                 "--deam3p", d3, "--device", "cuda", "--profile"],
                cwd=repo, capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                raise RuntimeError(f"keelime in {repo} failed:\n{r.stderr}")
            st = {m.group(1): float(m.group(2)) for m in re.finditer(
                r"^\s+(\S+)\s+([\d.]+)s \(", r.stderr, re.M)}
            return cs.KL_READS / sum(st[k] for k in STAGES), st["assemble"]

        repos = {"this": REPO, "other": os.path.abspath(other_repo)}
        for repo in repos.values():
            run(repo)  # warm-up: builds the checkout's libraries
        got = {"this": [], "other": []}
        for name in ("this", "other", "other", "this"):
            for _ in range(E2E_RUNS):
                got[name].append(run(repos[name]))
    print("keelime e2e, fresh processes: " + "; ".join(
        f"{n} " + " / ".join(f"{rps:.1f}" for rps, _ in runs)
        + f" reads/s (mean {sum(r for r, _ in runs) / len(runs):.1f}), "
        "assemble " + " / ".join(f"{a:.2f}" for _, a in runs)
        + f" s (mean {sum(a for _, a in runs) / len(runs):.2f})"
        for n, runs in got.items()) + f"; on {smi}", flush=True)


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from .pipelines import keelime_device as kd

    other_repo = None
    if "--e2e" in args:
        k = args.index("--e2e")
        other_repo = args[k + 1]
        args = args[:k] + args[k + 2:]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    other, kind = _load_other(os.path.abspath(args[0]))
    print(f"this: {_native.KEELIME_SRC} (L_WARP {kd.L_WARP}); other: "
          f"{args[0]} ({kind}); on {smi}", flush=True)
    with tempfile.TemporaryDirectory(prefix="vgan_overlap_ab_") as tmp:
        calls = keelime_calls(dev, tmp)
    merge = calls[1:] or calls[:1]
    largest = max(merge, key=lambda c: c[2].numel())
    labelled = [("find_overlaps", calls[0])] + [
        ("largest merge" if c is largest else f"merge call {i}", c)
        for i, c in enumerate(calls[1:], 1)]

    def equal(x, y):
        return torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])

    for label, call in labelled:
        buf, off, ai, bi, mo, ms = call[:6]
        la = (off[ai.long() + 1] - off[ai.long()]).cpu()
        n_long = int((la > kd.L_WARP).sum())
        desc = (f"{label}: {ai.numel()} pairs, la {int(la.min())}-"
                f"{int(la.max())} bp, {n_long} over L_WARP")
        whole, alone = other_runs(other, kind, call)
        if not equal(kd.overlap_best_indexed(*call), whole()):
            raise AssertionError(f"{label}: this and other differ")
        runs = {"call": (lambda: kd.overlap_best_indexed(*call), whole)}
        if n_long:
            order, n_short = kd.split_by_length(
                off[ai.long() + 1] - off[ai.long()])
            out = [torch.empty(ai.numel(), dtype=t, device=dev)
                   for t in (torch.int64, torch.float64)]
            hints = host_hints(call)
            G = kd.block_scan(buf, off, ai, bi, order, n_short, mo, ms, *out,
                              *hints)
            mine = [t.clone() for t in out]
            theirs = alone()
            ks = order[int(n_short):].long()
            if not (torch.equal(mine[0][ks], theirs[0][ks])
                    and torch.equal(mine[1][ks], theirs[1][ks])):
                raise AssertionError(f"{label}: block kernels differ")
            runs[f"block kernel (this at G={G})"] = (
                lambda: kd.block_scan(buf, off, ai, bi, order, n_short, mo,
                                      ms, *out, *hints), alone)
        for what, (this_run, other_run) in runs.items():
            times = {"this": [], "other": []}
            for name in ("this", "other", "other", "this"):
                fn = this_run if name == "this" else other_run
                times[name].append(cs.cuda_ms(fn, reps=5))
            print(f"{desc}: {what} equal; " + "; ".join(
                f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                for n, ts in times.items()) + f"; on {smi}", flush=True)
    if other_repo is not None:
        e2e(other_repo, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
