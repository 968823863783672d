"""Times this checkout's tree-MCMC kernel (csrc/tree_mcmc.cu) against
another build, for example a parent commit's tree_mcmc.cu unpacked with
`git archive`, at chip_smoke.py's soibean shapes: the k-sweep batch of
its soibean world (12 rows of k = 1..3 sources, 4,000 64-bp reads, 255
paths), taken from a short `soibean --device cuda` run on that world.

    python -m vgan_tpu_torch.tree_ab OTHER_TREE_MCMC_CU

The other source may have this checkout's C interface or the one before
thread-block clusters (no cluster argument, one block a row); it is
built as a second library beside the checkout's, both at once. Both run
SB_CHECK_BURN burn-in and SB_CHECK_POST post-burn-in steps of the batch
from the same start with one noise draw: node ids must be equal and
positions, proportions and log-likelihoods within rtol 1e-10. Then each
is timed a step (CUDA events, SB_TIMED_STEPS steps, 5 calls) post-burn-in
and in burn-in, and at the serial floor (the same steps with R cut to 32
reads a CTA of this checkout's cluster), in the order this, other, other,
this. This checkout's kernel runs at the cluster size its wrapper
chooses. Run it from the root of a checkout on a machine with an NVIDIA
GPU and nvcc. Each line names the card and its power limit.
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


class _OneBlockLib:
    """A library of the interface before clusters, called with this
    checkout's arguments: the cluster size is dropped."""

    def __init__(self, lib):
        self.lib = lib

    def tree_mcmc_segment_launch(self, *args):
        return self.lib.tree_mcmc_segment_launch(*args[:-2], args[-1])


def _load_other(path):
    """The tree_mcmc.cu at `path` built as a second library (its own name
    in _build/), typed as _native.tree_mcmc_lib types the checkout's or,
    without a residency query, as the interface before clusters."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = _native._find_tool("nvcc",
                              [os.path.join(cuda_home, "bin", "nvcc")])
    ours = threading.Thread(target=_native.tree_mcmc_lib)  # both at once
    ours.start()
    lib = ctypes.CDLL(_native._build("vgan_tree_mcmc_other", nvcc,
                                     _native.NVCC_FLAGS, [path], []))
    ours.join()
    typed = _native.tree_mcmc_lib()
    launch = typed.tree_mcmc_segment_launch
    lib.tree_mcmc_segment_launch.restype = launch.restype
    if hasattr(lib, "tree_mcmc_max_active_clusters"):
        lib.tree_mcmc_segment_launch.argtypes = launch.argtypes
        query = typed.tree_mcmc_max_active_clusters
        lib.tree_mcmc_max_active_clusters.restype = query.restype
        lib.tree_mcmc_max_active_clusters.argtypes = query.argtypes
        return lib, "clusters"
    # the cluster size is the second-to-last argument
    lib.tree_mcmc_segment_launch.argtypes = (launch.argtypes[:-2]
                                             + launch.argtypes[-1:])
    return _OneBlockLib(lib), "one block a row"


def ksweep_call(dev, out_dir):
    """(args, kw) of run_tree_mcmc_ksweep in a short soibean run on
    chip_smoke.py's soibean world (its batch does not depend on the
    chain's length)."""
    import chip_smoke as cs
    from .cli import main as cli_main
    from .infer import tree_mcmc as tm

    db_dir, fq, _planted, _parents, _n = cs.build_soibean_world(out_dir)
    ksweep, calls = tm.run_tree_mcmc_ksweep, []

    def keeping(*args, **kw):
        calls.append((args, kw))
        return ksweep(*args, **kw)

    tm.run_tree_mcmc_ksweep = keeping
    try:
        argv = ["soibean", "--soibean_dir", db_dir, "--dbprefix",
                cs.SB_PREFIX, "-fq1", fq, "-o", os.path.join(out_dir, "sb_"),
                "--chains", str(cs.SB_CHAINS), "--iter", "2000", "--burnin",
                "300", "--device", str(dev)]
        if cli_main(argv) != 0:
            raise RuntimeError("cli soibean failed")
    finally:
        tm.run_tree_mcmc_ksweep = ksweep
    return calls[-1]


def main(argv=None) -> int:
    import numpy as np
    import torch

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from .infer import tree_mcmc as tm

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    other, kind = _load_other(os.path.abspath(args[0]))
    ours = _native.tree_mcmc_lib()
    libs = {"this": ours, "other": other}
    print(f"this: {_native.TREE_MCMC_SRC}; other: {args[0]} ({kind}); "
          f"on {smi}", flush=True)
    with tempfile.TemporaryDirectory(prefix="vgan_tree_ab_") as tmp:
        call_args, kw = ksweep_call(dev, tmp)
    data = call_args[1]
    srcs, mask, theta0, ll0, seeds = tm.ksweep_rows(
        call_args[3], kw["init_logls"], kw["seeds_per_k"], dev)
    B, K = srcs.shape
    P, R = data.path_map_t.shape
    N, Cc = data.tree.children.shape
    G = tm.card_cluster_size(dev, B, K, N, Cc, data.counts25_t.dtype)
    sd_all = tm.sd_schedule(cs.SB_ITER, cs.SB_BURNIN, kw["num_paths"])
    burn_hops = tm.burn_walk_hops(kw["num_paths"])
    post0 = cs.SB_BURNIN + 1
    mask_t = torch.as_tensor(mask).to(dev)

    def run_with(name, carry, i0, noise, pm, c25):
        """One segment of `name`'s kernel from a copy of `carry`."""
        _native._loaded["tree_mcmc"] = libs[name]
        try:
            n = noise.acc_u.shape[1]
            return tm.run_segment(
                *(x.clone() for x in carry), mask_t,
                torch.arange(i0, i0 + n, device=dev),
                torch.from_numpy(sd_all[i0:i0 + n]).to(dev), noise, pm, c25,
                data.tree, data.con, data.freq, cluster=G)
        finally:
            _native._loaded["tree_mcmc"] = ours

    start = (torch.as_tensor(srcs).to(dev),
             torch.full((B, K), 0.5, dtype=torch.float64, device=dev),
             theta0.to(dev), torch.as_tensor(ll0).to(dev))
    carry = {"this": start, "other": start}
    recs = {"this": [], "other": []}
    for i0, i1, hops in ((0, cs.SB_CHECK_BURN, burn_hops),
                         (post0, post0 + cs.SB_CHECK_POST,
                          tm.POST_BURN_HOPS)):
        noise = tm.draw_noise(seeds, i0, i1, K, hops, dev)
        for name in libs:
            carry[name], rec = run_with(name, carry[name], i0, noise,
                                        data.path_map_t, data.counts25_t)
            recs[name].append(rec)
    torch.cuda.synchronize()
    max_err = 0.0
    for a, b in zip(recs["this"], recs["other"]):
        if not torch.equal(a[0], b[0]):
            raise AssertionError("this and other: node ids differ")
        for x, y in zip(a[1:], b[1:]):
            if bool(((x - y).abs() > 1e-10 * y.abs()).any()):
                raise AssertionError("this and other: values past rtol "
                                     "1e-10")
            max_err = max(max_err, float((x - y).abs().max()))
    print(f"k-sweep batch B={B} Kmax={K} R={R} P={P}, clusters of {G}: "
          f"{cs.SB_CHECK_BURN} + {cs.SB_CHECK_POST} steps, ids equal, max "
          f"abs err {max_err:.3g}; on {smi}", flush=True)

    c0 = carry["this"]
    n = cs.SB_TIMED_STEPS
    rf = G * 32
    floor = (data.path_map_t[:, :rf].contiguous(),
             data.counts25_t[:, :rf].contiguous())
    for label, i0, hops in (("post-burn-in", post0, tm.POST_BURN_HOPS),
                            ("burn-in", 0, burn_hops)):
        noise = tm.draw_noise(seeds, i0, i0 + n, K, hops, dev)
        for what, (pm, c25) in (("", (data.path_map_t, data.counts25_t)),
                                (f" serial floor (R = {rf})", floor)):
            times = {"this": [], "other": []}
            for name in ("this", "other", "other", "this"):
                times[name].append(1e3 * cs.cuda_ms(
                    lambda: run_with(name, c0, i0, noise, pm, c25),
                    reps=5) / n)
            print(f"{label} ({hops} hops){what}: " + "; ".join(
                f"{name} " + " / ".join(f"{t:.2f}" for t in ts)
                for name, ts in times.items())
                + f" us a step; this/other "
                f"{np.mean(times['this']) / np.mean(times['other']):.3f}; "
                f"on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
