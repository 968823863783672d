"""Times this checkout's HaploCart likelihood-step kernel
(csrc/haplocart.cu) against another build, for example a parent commit's
haplocart.cu unpacked with `git archive`, on chip_smoke.py's HaploCart
world: every score_packed call (a flush, M = 65,536, S = 8) of a
`haplocart --device cuda` run.

    python -m vgan_tpu_torch.hc_ab OTHER_HAPLOCART_CU

The other source is built as a second library beside the checkout's,
both at once, and called through the same wrapper (node_scores; its C
entry point hc_node_scores_launch has kept its signature). A source
whose launch adds to c and sum(b) (one without hc_zero_kernel, as
before the kernel zeroed them itself) gets them zeroed first with
torch's fills, as its wrapper did. On each call both must give c within
1e-12 of each node's sum of |A - b| of node_scores_plain's and sum(b)
within rtol 1e-12. Then each is timed, in the order this, other, other,
this: on the device alone (calls queued behind a spin kernel, so the
wrapper's host time is hidden) and by CUDA events back to back; and, on
the device alone, on two ablations of the call's rows that split its
time: node ids out of range (no atomic add) and, besides, no position
(take = 0, b = 0: the row loads and table gathers alone). Run it from
the root of a checkout on a machine with an NVIDIA GPU and nvcc. Each
line names the card and its power limit.
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


class _Zeroing:
    """A library whose launch adds to c and sum(b), called as the
    checkout's (which writes them): both zeroed first with torch."""

    def __init__(self, lib):
        self.lib = lib

    def hc_node_scores_launch(self, *args):
        n_nodes, c, total_b = args[-4], args[-3], args[-2]
        for ptr, n in ((c, n_nodes), (total_b, 1)):
            _wrap(ptr.value, n).zero_()
        return self.lib.hc_node_scores_launch(*args)


def _wrap(ptr, n):
    """The n f64 on the current card at `ptr` as a tensor (no copy)."""
    import torch

    class _Array:
        __cuda_array_interface__ = {"shape": (n,), "typestr": "<f8",
                                    "data": (ptr, False), "version": 3}

    return torch.as_tensor(_Array(), device="cuda")


def _load_other(path):
    """The haplocart.cu at `path` built as a second library (its own name
    in _build/), typed as the checkout's; wrapped in _Zeroing where its
    launch adds to c and sum(b)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = _native._find_tool("nvcc",
                              [os.path.join(cuda_home, "bin", "nvcc")])
    ours = threading.Thread(target=_native.haplocart_lib)  # both at once
    ours.start()
    lib = ctypes.CDLL(_native._build("vgan_haplocart_other", nvcc,
                                     _native.NVCC_FLAGS, [path], []))
    ours.join()
    lib.hc_node_scores_launch.restype = ctypes.c_int
    lib.hc_node_scores_launch.argtypes = _native.HC_NODE_SCORES_ARGTYPES
    with open(path) as f:
        zeroes = "hc_zero_kernel" in f.read()
    return (lib, "zeroes c") if zeroes else (_Zeroing(lib), "adds to c")


def score_calls(dev, out_dir):
    """The score_packed calls of a `haplocart --device cuda` run on
    chip_smoke.py's HaploCart world: (buf, tables, bep, M, S,
    consensus) each."""
    import chip_smoke as cs
    from .cli import main as cli_main
    from .pipelines import haplocart_device as hd

    db_dir, fq = cs.build_world(out_dir)
    scorer, calls = hd.score_packed, []

    def keeping(buf, t, bep, M, S, consensus=False):
        calls.append((buf, t, bep, M, S, consensus))
        return scorer(buf, t, bep, M, S, consensus)

    hd.score_packed = keeping
    try:
        if cli_main(["haplocart", "--db", db_dir, "-fq1", fq, "-o",
                     os.path.join(out_dir, "hc.tsv"), "--device",
                     str(dev)]) != 0:
            raise RuntimeError("cli haplocart failed")
    finally:
        hd.score_packed = scorer
    return calls


def ablations(buf, M, S, dtype):
    """(label, views) of the call's rows and of the two ablations (on
    copies of its buffer): node ids out of range, and besides no position
    (take = 0, b = 0)."""
    from .pipelines import haplocart_device as hd

    out = [("the call", hd.unpack(buf, M, S, dtype))]
    for label in ("no atomic add", "no position, no atomic add"):
        v = hd.unpack(buf.clone(), M, S, dtype)
        v.node.fill_(-1)
        if label.startswith("no position"):
            v.take.zero_()
            v.b.zero_()
        out.append((label, v))
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from .pipelines import haplocart_device as hd

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    other, kind = _load_other(os.path.abspath(args[0]))
    ours = _native.haplocart_lib()
    libs = {"this": ours, "other": other}
    print(f"this: {_native.HAPLOCART_SRC}; other: {args[0]} ({kind}); on "
          f"{smi}", flush=True)
    with tempfile.TemporaryDirectory(prefix="vgan_hc_ab_") as tmp:
        calls = score_calls(dev, tmp)

    def run(name, views, t, bep, cons):
        _native._loaded["haplocart"] = libs[name]
        try:
            return hd.node_scores(views, t, bep, cons)
        finally:
            _native._loaded["haplocart"] = ours

    for i, (buf, t, bep, M, S, cons) in enumerate(calls):
        views = hd.unpack(buf, M, S, t.support.dtype)
        pc, pb = hd.node_scores_plain(views, t, bep, cons)
        err = 0.0
        for name in libs:
            c, total_b = run(name, views, t, bep, cons)
            err = max(err, cs._close_to_node_sums(
                f"{name} call {i} c", c, pc, views, t, bep, cons, 1e-12),
                cs._close(f"{name} call {i} sum(b)", total_b, pb, 1e-12))
        live = int((views.take > 0).sum())
        print(f"call {i} M={M} S={S} ({live} live rows): this and other "
              f"equal to plain (max abs err {err:.3g}); on {smi}",
              flush=True)
        for label, v in ablations(buf, M, S, t.support.dtype):
            dev_ms = {"this": [], "other": []}
            ev_ms = {"this": [], "other": []}
            for name in ("this", "other", "other", "this"):
                dev_ms[name].append(cs.queued_ms(
                    lambda: run(name, v, t, bep, cons), 50))
                if label == "the call":
                    ev_ms[name].append(cs.cuda_ms(
                        lambda: run(name, v, t, bep, cons), reps=50))

            def txt(ms):
                return " / ".join("not measured" if x is None
                                  else f"{x:.4f}" for x in ms)

            line = (f"call {i}, {label}: on the device alone " + "; ".join(
                f"{name} {txt(ms)}" for name, ms in dev_ms.items()) + " ms")
            if label == "the call":
                line += "; by events back to back " + "; ".join(
                    f"{name} {txt(ms)}" for name, ms in ev_ms.items()) + " ms"
            if all(x is not None for ms in dev_ms.values() for x in ms):
                line += (f"; this/other on the device "
                         f"{np.mean(dev_ms['this']) / np.mean(dev_ms['other']):.3f}")
            print(line + f"; on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
