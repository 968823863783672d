"""Times this checkout's abundance-chain kernel (csrc/abundance_mcmc.cu)
against another build, for example a parent commit's abundance_mcmc.cu
unpacked with `git archive`, on chip_smoke.py's euka shapes: the chain
segment of a `euka --device cuda` run on its euka world (9,899 steps of
the three detected taxa), a high-acceptance chain of the same shape
(4 / 3 / 2 reads, a uniform start: most steps accept) and the T = 1
floor (every step accepts).

    python -m vgan_tpu_torch.abundance_ab OTHER_ABUNDANCE_MCMC_CU

The other source is built as a second library beside the checkout's,
both at once, and called through the same wrapper (run_segment; its C
entry point abundance_mcmc_segment_launch has kept its signature). On
each chain both must give proposals, state and likelihood within rtol
1e-12 of each other, with the same accepted steps (replayed from the
proposals, accepted_steps). Then each is timed a step (CUDA events over
5 launches) in the order this, other, other, this, beside the chain's
acceptance and this checkout's rounds (window_rounds at its window).
Run it from the root of a checkout on a machine with an NVIDIA GPU and
nvcc. Each line names the card and its power limit.
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
    """The abundance_mcmc.cu at `path` built as a second library (its own
    name in _build/), its entry point typed as the checkout's."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = _native._find_tool("nvcc",
                              [os.path.join(cuda_home, "bin", "nvcc")])
    ours = threading.Thread(target=_native.abundance_mcmc_lib)  # both
    ours.start()
    lib = ctypes.CDLL(_native._build("vgan_abundance_mcmc_other", nvcc,
                                     _native.NVCC_FLAGS, [path], []))
    ours.join()
    lib.abundance_mcmc_segment_launch.restype = ctypes.c_int
    lib.abundance_mcmc_segment_launch.argtypes = (
        _native.ABUNDANCE_MCMC_ARGTYPES)
    return lib


def cli_segment(dev, out_dir):
    """run_segment's arguments in a `euka --device cuda` run on
    chip_smoke.py's euka world."""
    import chip_smoke as cs
    from .cli import main as cli_main
    from .infer import abundance_mcmc as am

    euka_dir, d5, d3, fq, _n = cs.build_euka_world(out_dir)
    segment, calls = am.run_segment, []

    def keeping(*args, **kw):
        calls.append(args)
        return segment(*args, **kw)

    am.run_segment = keeping
    try:
        argv = (["euka", "--euka_dir", euka_dir, "-fq1", fq, "-o",
                 os.path.join(out_dir, "euka_out"), "--deam5p", d5,
                 "--deam3p", d3, "--device", str(dev)] + cs.EUKA_GATES)
        if cli_main(argv) != 0:
            raise RuntimeError("cli euka failed")
    finally:
        am.run_segment = segment
    return calls[-1]


def chain(dev, n_reads, init, const, S, seed):
    """run_segment's arguments of a chain from START_LL, noise from
    draw_noise(S, T, seed)."""
    import numpy as np
    import torch

    from .infer import abundance_mcmc as am

    def f(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    z, u = am.draw_noise(S, len(n_reads), seed)
    return (f(init), f(am.START_LL), z.to(dev), u.to(dev), 0.1, f(n_reads),
            f(const))


def main(argv=None) -> int:
    import numpy as np
    import torch

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from .infer import abundance_mcmc as am

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    other = _load_other(os.path.abspath(args[0]))
    ours = _native.abundance_mcmc_lib()
    libs = {"this": ours, "other": other}
    print(f"this: {_native.ABUNDANCE_MCMC_SRC}; other: {args[0]}; on {smi}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="vgan_abundance_ab_") as tmp:
        seg = cli_segment(dev, tmp)
    S = seg[2].shape[0]
    chains = {
        "the CLI run's segment": seg,
        "high acceptance (4 / 3 / 2 reads)": chain(
            dev, [4.0, 3.0, 2.0], [1 / 3] * 3, -5.0, S, seed=3),
        "T = 1 (every step accepts)": chain(dev, [17.0], [1.0], -2.0, S,
                                            seed=5),
    }

    def run(name, a):
        _native._loaded["abundance_mcmc"] = libs[name]
        try:
            return am.run_segment(*a)
        finally:
            _native._loaded["abundance_mcmc"] = ours

    for label, a in chains.items():
        S, T = a[2].shape
        out = {name: run(name, a) for name in libs}
        torch.cuda.synchronize()
        steps, margins = {}, {}
        for name, ((_state, _ll), props) in out.items():
            steps[name], margins[name] = am.accepted_steps(
                props, a[3], a[5], a[6], a[1])
        (ts, tl), tp = out["this"]
        (os_, ol), op = out["other"]
        err = max(cs._close("this and other: proposals", tp, op, 1e-12),
                  cs._close("this and other: state", ts, os_, 1e-12),
                  cs._close("this and other: likelihood", tl, ol, 1e-12))
        if steps["this"] != steps["other"]:
            raise AssertionError(f"{label}: this and other accept other "
                                 "steps")
        d = am.window(T)
        rounds = am.window_rounds(steps["this"], S, d)
        times = {"this": [], "other": []}
        for name in ("this", "other", "other", "this"):
            times[name].append(1e3 * cs.cuda_ms(lambda: run(name, a),
                                                reps=5) / S)
        print(f"{label} (T={T}, S={S}): acceptance "
              f"{len(steps['this']) / S:.4f} (smallest margin "
              f"{float(margins['this'].min()):.3g}), this checkout's window "
              f"{d}: "
              f"{rounds} rounds, {S / rounds:.2f} steps a round; equal "
              f"(max abs err {err:.3g}, same accepted steps); "
              + "; ".join(f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
                          for name, ts in times.items())
              + f" us a step; this/other "
              f"{np.mean(times['this']) / np.mean(times['other']):.3f}; "
              f"on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
