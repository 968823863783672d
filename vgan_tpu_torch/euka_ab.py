"""Times this checkout's euka per-base scorer kernel (csrc/euka.cu)
against another build of it, for example a parent commit's euka.cu
unpacked with `git archive`, at euka's shape and at a 1,000-bp batch.

    python -m vgan_tpu_torch.euka_ab OTHER_EUKA_CU [--flags=F,F]

The other source is built as a second library beside the checkout's,
both at once, with the extra nvcc flags F (written after "=" since they
start with "-"), and called through the same wrapper (score_batch; the
C entry point euka_score_launch has kept its signature). On the
checkout's own euka.cu the flags give its measurement builds, for
example --flags=-DVGAN_EUKA_TABLES_L1 (every CTA reads the damage
tables through L1), -DVGAN_EUKA_SCALAR_LOADS (no 16-byte code loads) or
-DVGAN_EUKA_MIN_BLOCKS=4 (the registers sized for four CTAs an SM). The
shapes, each made from a seed on the card with the checkout's
damage-table layout:

* euka: B = 4,096 rows of L = 64, 64-bp reads of both orientations (as
  the euka CLI's calls on chip_smoke.py's world);
* 1,000 bp: chip_smoke.synthetic_euka_args, B = 2,048 forward reads of
  924-1,024 columns in an L = 1,024 bucket (the smoke's batch);
* 1,000 bp, both orientations: chip_smoke.both_orientations of it, half
  of the reads reverse (n_pos counting down), whose CTAs stage their
  table rows in two rounds.

On each, both builds must equal score_batch_plain to rtol 1e-12 (NaN
where NaN); then each is timed in the order this, other, other, this:
on the device alone (calls queued behind a spin kernel, the wrapper's
host time hidden) and by CUDA events back to back. Run it from the root
of a checkout on a machine with an NVIDIA GPU and nvcc. Each line names
the card and its power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading

from . import _native

REPO = os.path.dirname(_native._PKG_DIR)


def _load_other(path, flags=()):
    """The euka.cu at `path` built as a second library (its own name in
    _build/) with the extra nvcc `flags`, its entry points typed as the
    checkout's; the checkout's own library built at the same time."""
    ours = threading.Thread(target=_native.euka_lib)
    ours.start()
    lib = _native.euka_build("vgan_euka_other", list(flags), path)
    ours.join()
    return lib


def euka_shape_args(tables, B=4096, L=64, seed=3):
    """score_batch's arguments for B 64-bp reads of both orientations in
    an L-column bucket on the tables' device: ACGT with 2 %
    substitutions, qualities 20..40, pair distance 0.03; `tables`:
    (sub5p, sub3p, qtab, bfreq, ttr)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=(B, L))
    r = np.where(rng.random((B, L)) < 0.98, g, rng.integers(0, 4, (B, L)))
    col = np.arange(L)[None, :]
    rev = rng.random(B) < 0.5
    n_pos = np.where(rev[:, None], L - 1 - col, col)
    dev = tables[0].device

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    i32 = torch.int32
    return (t(g, i32), t(r, i32), t(rng.integers(20, 41, (B, L)), i32),
            t(n_pos, i32), t(np.full(B, L), i32),
            t(np.full(B, 0.03), torch.float64),
            t(np.ones((B, L), bool), torch.bool)) + tuple(tables)


def damage_tables(dev, maxlen=1000, seed=2):
    """Random 5' / 3' damage tables ([maxlen, 4, 4] f64, small rates off
    the diagonal, rows summing to 1) and euka's qtab, bfreq and ttr."""
    import numpy as np
    import torch

    from .models import phred
    from .pipelines import euka as ek

    rng = np.random.default_rng(seed)
    idx = np.arange(4)
    out = []
    for _ in range(2):
        t = rng.random((maxlen, 4, 4)) * 0.08
        t[:, idx, idx] = 0.0
        t[:, idx, idx] = 1.0 - t.sum(-1)
        out.append(t)
    return tuple(torch.as_tensor(np.asarray(x, np.float64), device=dev)
                 for x in out + [phred.qscore_vec(), ek.BASE_FREQ_LOG,
                                 ek.T_T_RATIO])


def main(argv=None) -> int:
    import numpy as np
    import torch

    import argparse

    ap = argparse.ArgumentParser(usage=__doc__)
    ap.add_argument("other")
    ap.add_argument("--flags", default="")
    try:
        ns = ap.parse_args(sys.argv[1:] if argv is None else argv)
    except SystemExit:
        return 2
    flags = [f for f in ns.flags.split(",") if f]
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from .pipelines import euka as ek

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    other = _load_other(os.path.abspath(ns.other), flags)
    ours = _native.euka_lib()
    libs = {"this": ours, "other": other}
    print(f"this: {_native.EUKA_SRC}; other: {ns.other} {' '.join(flags)}; "
          f"on {smi}", flush=True)
    tables = damage_tables(dev)
    long = cs.synthetic_euka_args(tables, cs.EUKA_LONG_B, cs.EUKA_LONG_L)
    shapes = (("euka B=4096 L=64", euka_shape_args(tables)),
              ("1,000 bp B=2048 L=1024", long),
              ("1,000 bp both orientations", cs.both_orientations(long)))

    def run(name, a):
        _native._loaded["euka"] = libs[name]
        try:
            return ek.score_batch(*a)
        finally:
            _native._loaded["euka"] = ours

    for label, a in shapes:
        want = ek.score_batch_plain(*a)
        err = 0.0
        for name in libs:
            got = run(name, a)
            for k in range(2):
                err = max(err, cs._close(f"{name} {label} row {k}", got[k],
                                         want[k], 1e-12))
        ops, moved, _cols = cs.euka_work(a)
        bms, by = cs.f64_bound_ms(ops, moved)
        dev_ms = {"this": [], "other": []}
        ev_ms = {"this": [], "other": []}
        for name in ("this", "other", "other", "this"):
            dev_ms[name].append(cs.queued_ms(lambda: run(name, a), 20))
            ev_ms[name].append(cs.cuda_ms(lambda: run(name, a), reps=20))

        def txt(ms):
            return " / ".join("not measured" if x is None else f"{x:.4f}"
                              for x in ms)

        line = (f"{label}: this and other equal to plain (max abs err "
                f"{err:.3g}); bound {bms:.5f} ms ({by}); on the device alone "
                + "; ".join(f"{n} {txt(ms)}" for n, ms in dev_ms.items())
                + " ms; by events back to back "
                + "; ".join(f"{n} {txt(ms)}" for n, ms in ev_ms.items())
                + " ms")
        if all(x is not None for ms in dev_ms.values() for x in ms):
            line += (f"; this/other on the device "
                     f"{np.mean(dev_ms['this']) / np.mean(dev_ms['other']):.3f}")
        print(line + f"; on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
