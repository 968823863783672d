"""Times this checkout's overlap scans (csrc/keelime.cu) against another
build, for example a parent commit's keelime.cu unpacked with
`git archive`, on chip_smoke.py's keelime batches: the find_overlaps
batch and the largest merge batch, taken from a short `keelime --device
cuda` run on chip_smoke.py's keelime world.

    python -m vgan_tpu_torch.overlap_ab OTHER_KEELIME_CU
        [--e2e OTHER_CHECKOUT]

The other source may have this checkout's C interface (a sequence table
and index arrays) or the one before it (pairs packed back to back as
bytes, one 128-thread block a pair), which gets each batch gathered from
the table into that layout on the card first. Both libraries are built at
once. Each batch goes once through both (the results must be equal), then
each is timed with CUDA events over 5 calls in the order this, other,
other, this: this checkout's whole call (the split and the kernels it
launches) beside the other's kernel, then this checkout's warp and block
kernels alone on their classes. Last, the
host side of find_overlaps' call, wall clock to results on the host:
before (a list of string pairs, packed into bytes, uploaded, the other's
kernel, the results turned into a list and back into arrays) and after
(the interned table and the index arrays uploaded, this checkout's call,
the results downloaded as arrays). With --e2e, keelime end to end on
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
import time

from . import _native

REPO = os.path.dirname(_native._PKG_DIR)


def _load_other(path):
    """(library, "indexed" or "packed"): the keelime.cu at `path` built as
    a second library (its own name in _build/), typed as this checkout's
    or as the packed-pair interface before it."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = _native._find_tool("nvcc",
                              [os.path.join(cuda_home, "bin", "nvcc")])
    ours = threading.Thread(target=_native.keelime_lib)  # both at once
    ours.start()
    lib = ctypes.CDLL(_native._build("vgan_keelime_other", nvcc,
                                     _native.NVCC_FLAGS, [path], []))
    ours.join()
    if hasattr(lib, "overlap_warp_launch"):
        _native._type_keelime(lib)
        return lib, "indexed"
    vp, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    lib.overlap_best_launch.restype = ctypes.c_int
    lib.overlap_best_launch.argtypes = [
        vp, vp, vp, vp, i64,       # abuf, aoff, bbuf, boff, n
        vp, vp,                    # lut [256] uint8, table2 [16, 16] int32
        i64, f64,                  # min_olen, min_score
        vp, vp,                    # out_len, out_score
        vp,                        # stream
    ]
    return lib, "packed"


def keelime_calls(dev, out_dir):
    """Every overlap_best_indexed call of a keelime run on chip_smoke.py's
    keelime world: [(seq_buf, seq_off, ai, bi, min_olen, min_score,
    longest)]."""
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


def packed_run(lib, call):
    """The packed-pair library on one call: returns run() that scans the
    pairs gathered from the table into that layout (bytes, on the card)
    and gives (out_len, out_score)."""
    import torch

    from .pipelines import keelime_device as kd

    seq_buf, seq_off, ai, bi, min_olen, min_score = call[:6]
    dev = seq_buf.device
    abuf, aoff = kd.gather_packed(seq_buf, seq_off, ai)
    bbuf, boff = kd.gather_packed(seq_buf, seq_off, bi)
    lut, t2 = (torch.from_numpy(x.reshape(-1)).to(dev)
               for x in kd.code_tables())
    n = ai.numel()

    def run():
        out = (torch.empty(n, dtype=torch.int64, device=dev),
               torch.empty(n, dtype=torch.float64, device=dev))
        rc = lib.overlap_best_launch(
            abuf.data_ptr(), aoff.data_ptr(), bbuf.data_ptr(),
            boff.data_ptr(), n, lut.data_ptr(), t2.data_ptr(), int(min_olen),
            float(min_score), out[0].data_ptr(), out[1].data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"other overlap_best launch: CUDA error {rc}")
        return out

    return run


def host_side(lib, kind, call, smi):
    """find_overlaps' call, host to host: the packed-pair steps (string
    pairs, packed, uploaded, the other's kernel, unpacked) against this
    checkout's (table and indices uploaded, the call, arrays
    downloaded). Seconds of each, twice, in the order before, after,
    after, before."""
    import numpy as np
    import torch

    from .pipelines import keelime_device as kd
    from .pipelines.keelime import _enc

    seq_buf, seq_off, ai, bi, min_olen, min_score = call[:6]
    dev = seq_buf.device
    buf = seq_buf.cpu().numpy()
    off = seq_off.cpu().numpy()
    contents = [buf[off[k]:off[k + 1]].tobytes().decode("latin-1")
                for k in range(len(off) - 1)]
    C = len(contents)
    keys = ai.cpu().numpy().astype(np.int64) * C + bi.cpu().numpy()
    lut, t2 = (torch.from_numpy(x.reshape(-1)).to(dev)
               for x in kd.code_tables())

    def before():
        order = [(contents[int(k) // C], contents[int(k) % C]) for k in keys]
        n = len(order)
        aoff = np.zeros(n + 1, dtype=np.int64)
        boff = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(a) for a, _ in order], out=aoff[1:])
        np.cumsum([len(b) for _, b in order], out=boff[1:])
        abuf = _enc("".join(a for a, _ in order)).copy()
        bbuf = _enc("".join(b for _, b in order)).copy()
        packed = [torch.from_numpy(x).to(dev) for x in (abuf, aoff, bbuf,
                                                         boff)]
        out = (torch.empty(n, dtype=torch.int64, device=dev),
               torch.empty(n, dtype=torch.float64, device=dev))
        rc = lib.overlap_best_launch(
            *(t.data_ptr() for t in packed[:2]),
            *(t.data_ptr() for t in packed[2:]), n, lut.data_ptr(),
            t2.data_ptr(), int(min_olen), float(min_score),
            out[0].data_ptr(), out[1].data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"other overlap_best launch: CUDA error {rc}")
        res = list(zip(out[0].cpu().tolist(), out[1].cpu().tolist()))
        return (np.fromiter((r[0] for r in res), np.int64, n),
                np.fromiter((r[1] for r in res), np.float64, n))

    def after():
        table = kd.intern(contents)
        return tuple(t.cpu().numpy() for t in kd.overlap_best_indexed(
            *(torch.from_numpy(x).to(dev) for x in table),
            torch.from_numpy((keys // C).astype(np.int32)).to(dev),
            torch.from_numpy((keys % C).astype(np.int32)).to(dev),
            min_olen, min_score, kd.longest_of(table[1])))

    if kind != "packed":
        print("host side: the other library is not the packed-pair "
              "interface; skipped", flush=True)
        return
    got = {}
    secs = {"before": [], "after": []}
    for name in ("before", "after", "after", "before"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[name] = (before if name == "before" else after)()
        secs[name].append(time.perf_counter() - t0)
    if not all(np.array_equal(x, y) for x, y in zip(got["before"],
                                                    got["after"])):
        raise AssertionError("host side: before and after differ")
    print(f"find_overlaps call host to host ({len(keys)} pairs of {C} "
          f"contents): " + "; ".join(
              f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " s"
              for n, ts in secs.items()) + f"; on {smi}", flush=True)


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
    ours = _native.keelime_lib()
    print(f"this: {_native.KEELIME_SRC} (L_WARP {kd.L_WARP}); other: "
          f"{args[0]} ({kind}); on {smi}", flush=True)
    with tempfile.TemporaryDirectory(prefix="vgan_overlap_ab_") as tmp:
        calls = keelime_calls(dev, tmp)
    merge = calls[1:] or calls[:1]
    batches = (("find_overlaps", calls[0]),
               ("largest merge", max(merge, key=lambda c: c[2].numel())))

    def run_other(call):
        if kind == "packed":
            return packed_run(other, call)

        def run():
            _native._loaded["keelime"] = other
            try:
                return kd.overlap_best_indexed(*call)
            finally:
                _native._loaded["keelime"] = ours
        return run

    for label, call in batches:
        buf, off, ai, bi, mo, ms = call[:6]
        la = (off[ai.long() + 1] - off[ai.long()]).cpu()
        desc = (f"{label} batch: {ai.numel()} pairs, la {int(la.min())}-"
                f"{int(la.max())} bp, {int((la > kd.L_WARP).sum())} over "
                f"L_WARP")
        other_run = run_other(call)
        a, b = kd.overlap_best_indexed(*call), other_run()
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"{label}: this and other differ")
        times = {"this": [], "other": []}
        for name in ("this", "other", "other", "this"):
            fn = ((lambda: kd.overlap_best_indexed(*call)) if name == "this"
                  else other_run)
            times[name].append(cs.cuda_ms(fn, reps=5))
        print(f"{desc}: equal; " + "; ".join(
            f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms a call"
            for n, ts in times.items()) + f"; on {smi}", flush=True)
        order, n_short = kd.split_by_length(
            off[ai.long() + 1] - off[ai.long()])
        outs = [torch.empty(ai.numel(), dtype=t, device=dev)
                for t in (torch.int64, torch.float64)]
        alone = {}
        for name, scan in (("warp kernel", kd.warp_scan),
                           ("block kernel", kd.block_scan)):
            alone[name] = cs.cuda_ms(
                lambda scan=scan: scan(buf, off, ai, bi, order, n_short, mo,
                                       ms, *outs), reps=5)
        print(f"{label}: this alone: " + "; ".join(
            f"{n} {t:.4f} ms" for n, t in alone.items()) + f"; on {smi}",
            flush=True)
    host_side(other, kind, calls[0], smi)
    if other_repo is not None:
        e2e(other_repo, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
