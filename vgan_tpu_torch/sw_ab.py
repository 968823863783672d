"""Times this checkout's SW kernels (csrc/sw.cu) against another build of
the same C interface, for example a parent commit's sw.cu unpacked with
`git archive`, at the shapes chip_smoke.py times:

* sw_scores at the timing shape (B=32,768, R=128, W=192, full-length
  random pairs), on 1,000-bp reads, and on the one call of the mapper's
  object path over 1,000 of HaploCart's reads;
* gather_score_hash at the pool batch, a small batch (M=1,024), on
  1,000-bp reads, and on each call of a HaploCart CLI run and of a euka
  mapping of chip_smoke.py's worlds.

    python -m vgan_tpu_torch.sw_ab OTHER_SW_CU

Run it from the root of a checkout on a machine with an NVIDIA GPU and
nvcc. Each shape goes once through both libraries (the outputs must be
equal wherever both launch), then each library is timed with CUDA events
over 20 wrapper calls in the order this, other, other, this. A shape the
other library refuses (a thread-per-pair kernel past its shared-memory
limit) is reported as refused. One line per shape names the card and its
power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading

from . import _native

REPO = os.path.dirname(_native._PKG_DIR)


def _load_other(path):
    """The sw.cu at `path` built as a second library (its own name in
    _build/), typed as _native.sw_lib types the checkout's."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = _native._find_tool("nvcc",
                              [os.path.join(cuda_home, "bin", "nvcc")])
    ours = threading.Thread(target=_native.sw_lib)  # both builds at once
    ours.start()
    lib = ctypes.CDLL(_native._build("vgan_sw_other", nvcc,
                                     _native.NVCC_FLAGS, [path], []))
    ours.join()
    for fn in ("sw_scores_launch", "gather_score_hash_launch"):
        typed = getattr(_native.sw_lib(), fn)
        getattr(lib, fn).restype = typed.restype
        getattr(lib, fn).argtypes = typed.argtypes
    return lib


def _capture(module, name, run):
    """run() with module.<name> wrapped so each call's arguments are
    kept; returns them."""
    kernel, calls = getattr(module, name), []

    def keeping(*args):
        calls.append(args)
        return kernel(*args)

    setattr(module, name, keeping)
    try:
        run()
    finally:
        setattr(module, name, kernel)
    return calls


def _cases(dev, out_dir):
    """(label, wrapper, args) for every shape of the module docstring."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from .cli import main as cli_main
    from .graph.packed import PackedGraph
    from .io import fastx
    from .mapper import sw
    from .mapper.giraffe import BatchedMapper

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    cases = []
    rng = np.random.default_rng(42)
    B, R, W = cs.MAP_B, cs.MAP_R, cs.MAP_W
    cases.append((f"sw_scores B={B} R={R} W={W} full-length", "sw_scores",
                  on_card(rng.integers(0, 4, size=(B, R)).astype(np.int32),
                          rng.integers(0, 4, size=(B, W)).astype(np.int32),
                          np.full(B, R, np.int32), np.full(B, W, np.int32))))
    cases.append((f"sw_scores long reads B={cs.LONG_B} R={cs.LONG_R} "
                  f"W={cs.LONG_W}", "sw_scores",
                  on_card(*cs.mapper_shaped_batch(
                      rng, cs.LONG_B, cs.LONG_R, cs.LONG_W,
                      L=cs.LONG_READ_LEN))))
    pool = cs.pool_batch(np.random.default_rng(7), np.int32)
    small = cs.pool_batch(np.random.default_rng(8), np.int32, P=20_000_000,
                          n_reads=1024, n_pad=100, M=1024)
    long_pool = cs.pool_batch(np.random.default_rng(9), np.int32,
                              P=20_000_000, n_reads=cs.LONG_B, n_pad=256,
                              M=cs.LONG_B, Rmax=cs.LONG_R, Wmax=cs.LONG_W,
                              read_len=cs.LONG_READ_LEN)
    for key, a in (("pool", pool), ("small", small), ("long", long_pool)):
        cases.append((f"gather_score_hash {key} M={a[3].shape[1]} "
                      f"Rmax={a[1].shape[1]} Wmax={a[4]}",
                      "gather_score_hash", (*on_card(*a[:4]), a[4])))

    db_dir, fq = cs.build_world(out_dir)
    tsv = os.path.join(out_dir, "hc.tsv")
    argv = ["haplocart", "--db", db_dir, "-fq1", fq, "-o", tsv, "--device",
            str(dev)]

    def haplocart():
        if cli_main(argv) != 0:
            raise RuntimeError("cli haplocart failed")

    hc = _capture(sw, "gather_score_hash", haplocart)
    graph = PackedGraph.load(os.path.join(db_dir, "graph.npz"))
    reads = fastx.read_fastq(fq)[:cs.OBJECT_PATH_READS]
    obj = _capture(sw, "sw_scores", lambda: BatchedMapper(
        graph, k=31, w=11, device=dev)._map_reads_obj(reads))
    euka_dir, _d5, _d3, efq, _n = cs.build_euka_world(out_dir)
    egraph = PackedGraph.load(os.path.join(euka_dir, "euka_db.npz"))
    ereads = fastx.read_fastq(efq)
    eu = _capture(sw, "gather_score_hash", lambda: BatchedMapper(
        egraph, k=20, w=10, device=dev).map_reads_table(ereads))
    for label, name, calls in (("HaploCart", "gather_score_hash", hc),
                               ("object path", "sw_scores", obj),
                               ("euka", "gather_score_hash", eu)):
        for i, args in enumerate(calls):
            shape = (f"M={args[3].shape[1]} Rmax={args[1].shape[1]} "
                     f"Wmax={args[4]}" if name == "gather_score_hash" else
                     f"B={args[0].shape[0]} R={args[0].shape[1]} "
                     f"W={args[1].shape[1]}")
            cases.append((f"{label} {name} call {i} {shape}", name, args))
    return cases


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from .mapper import sw

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    other = _load_other(os.path.abspath(args[0]))
    ours = _native.sw_lib()
    libs = {"this": ours, "other": other}
    print(f"this: {_native.SW_SRC}; other: {args[0]}; on {smi}", flush=True)

    def run_with(name, wrapper, a):
        _native._loaded["sw"] = libs[name]
        try:
            return getattr(sw, wrapper)(*a)
        finally:
            _native._loaded["sw"] = ours

    with tempfile.TemporaryDirectory(prefix="vgan_sw_ab_") as tmp:
        cases = _cases(dev, tmp)
    for label, wrapper, a in cases:
        out = {"this": run_with("this", wrapper, a)}
        try:
            out["other"] = run_with("other", wrapper, a)
        except RuntimeError as e:  # the other library refused the launch
            print(f"{label}: other refused ({e})", flush=True)
        torch.cuda.synchronize()
        if "other" in out:
            got = [out[n] if isinstance(out[n], tuple) else (out[n],)
                   for n in ("this", "other")]
            if not all(torch.equal(x, y) for x, y in zip(*got)):
                raise AssertionError(f"{label}: this and other differ")
        times = {n: [] for n in out}
        for n in ("this", "other", "other", "this"):
            if n in out:
                times[n].append(cs.cuda_ms(
                    lambda n=n: run_with(n, wrapper, a), reps=20))
        print(f"{label}: " + "; ".join(
            f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms a call"
            for n, ts in times.items()) + f"; on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
