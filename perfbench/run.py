"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (the directory that holds BENCHMARK.json).
Everything about a cell is found by name: the workload in BENCHMARK.json
names its configuration (perfbench/configs/<config>.json, whose
`pipeline` names perfbench/pipelines/<pipeline>.py) and its traffic
(perfbench/traffic/<traffic>.json); each per-layer metric is read by
perfbench/metrics/<metric>.py.

A run builds the cell from the seed and warms it up (set-up, reported as
`setup_s`), then starts whole samples one after another until
`--seconds` have passed and takes the cell's rate over all their work
and all the time from the window's start to the end of the last sample.
With `--trace 1` the window runs under torch.profiler and the run reports
the per-layer metrics instead. Then the program's state is freed and the
plain reference judges what the timed samples produced. The last lines
of standard error give each number compared beside its limit; the last
line of standard output is the result as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "vgan_tpu")
NAME_CHARS = 200  # a templated kernel's name runs to kilobytes
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------------------ finding
def load_cell(root: str, workload: str):
    """(benchmark, workload entry, config, traffic) for a workload name,
    all read from files under `root`."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "perfbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, cfg, traffic


def reported(bench, cell, trace: bool):
    """The metric entries this cell reports in a run: its end-to-end
    metrics, or with trace its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in names]


def reader(root: str, name: str):
    """perfbench/metrics/<name>.py's `read`."""
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -------------------------------------------------------------------- host
def pin_host(device) -> str:
    """The deployment's host settings: the process on the CPUs it may
    use that are local to the card (all it may use when the card's PCI
    node does not say), torch's intra-op threads set to their count.
    Acts on this process only."""
    import torch

    allowed = sorted(os.sched_getaffinity(0))
    cpus, where = allowed, "no local CPU list"
    p = torch.cuda.get_device_properties(device) \
        if device.type == "cuda" else None
    if hasattr(p, "pci_bus_id"):
        path = (f"/sys/bus/pci/devices/{getattr(p, 'pci_domain_id', 0):04x}:"
                f"{p.pci_bus_id:02x}:{getattr(p, 'pci_device_id', 0):02x}.0"
                "/local_cpulist")
        try:
            with open(path) as f:
                where = f.read().strip()
            cpus = sorted(set(_cpulist(where)) & set(allowed)) or allowed
            where = "card-local " + where
        except OSError:
            pass
    os.sched_setaffinity(0, cpus)
    torch.set_num_threads(len(cpus))
    return (f"pinned to CPUs {cpus} of {allowed} ({where}), "
            f"{len(cpus)} torch threads")


def _cpulist(s: str):
    out = []
    for part in s.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += range(int(a), int(b) + 1)
        elif part:
            out.append(int(part))
    return out


# ------------------------------------------------------------------- spans
class Spans:
    """Host spans of the harness: (name, start ns, end ns) on the epoch
    clock the profiler's trace uses, each closed after the card has
    finished what was queued inside it."""

    def __init__(self, device):
        self.device = device
        self.items = []

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
            self.items.append((name, t0, time.time_ns()))

    def total_s(self, name):
        return sum(b - a for n, a, b in self.items if n == name) / 1e9


# ------------------------------------------------------------------- trace
def device_events(prof):
    """[(name, start ns, duration ns)] of the operations that ran on the
    card in a torch.profiler run."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            out.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
    return out


def busy_intervals(events, lo, hi):
    """Merged [start, end) ns of the card's activity inside [lo, hi)."""
    iv = sorted((max(s, lo), min(s + d, hi)) for _n, s, d in events
                if s + d > lo and s < hi)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def breakdown(events, merged, spans, lo, hi):
    """The ten device operations that took most time, and the ten
    longest idle gaps of the card named by the harness span the host was
    in (the innermost that covers the gap's middle)."""
    by = {}
    for n, _s, d in events:
        by[n] = by.get(n, 0) + d
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    gaps, prev = [], lo
    for a, b in merged + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) // 2
        cover = [s for s in spans if s[1] <= mid < s[2]]
        name = min(cover, key=lambda s: s[2] - s[1])[0] if cover else "between"
        named.append([name, (b - a) / 1e9])
    return ([[n[:NAME_CHARS], d / 1e9] for n, d in ops], named)


# --------------------------------------------------------------------- run
def run_window(run_sample, seconds, spans, clock=time.perf_counter):
    """Whole samples one after another, a new one started while fewer
    than `seconds` have passed (always at least one). Returns (samples,
    their work, seconds from the start to the end of the last one); the
    spans close after a synchronize, so the last sample's work is done."""
    t0 = clock()
    work, n = 0.0, 0
    while n == 0 or clock() - t0 < seconds:
        with spans("sample"):
            work += run_sample(n, spans)
        n += 1
    return n, work, clock() - t0


def run_cell(root, workload, seed, seconds, trace, device, t_start,
             overrides=None, control=False):
    """Set up, warm up, run the window and check one cell. Returns
    (result dict, [(name, value, limit)], the control's [(name, value,
    limit)] when `control`, else None). `overrides` replaces keys of the
    configuration and the traffic (the CPU tests' tiny sizes)."""
    import torch

    bench, cell, cfg, traffic = load_cell(root, workload)
    for k, v in (overrides or {}).items():
        (cfg if k in cfg else traffic)[k] = v
    pipe = importlib.import_module(f"perfbench.pipelines.{cfg['pipeline']}")
    dev = torch.device(device)
    log(pin_host(dev))
    spans = Spans(dev)
    c = pipe.Cell(cfg, traffic, seed, dev, log)
    c.warm_up(spans)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    spans.items.clear()

    profiler = contextlib.nullcontext()
    if trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CUDA])
    with profiler as prof:
        w0_ns = time.time_ns()
        n, work, window_s = run_window(c.run_sample, seconds, spans)
        w1_ns = time.time_ns()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window: {n} samples in {window_s:.3f} s ({work:.0f} units); "
        f"set-up {setup_s:.3f} s; spans " + json.dumps({
            k: round(spans.total_s(k), 3)
            for k in sorted({s[0] for s in spans.items})}))

    metrics, dev_info, extra = {}, {}, {}
    entries = reported(bench, cell, trace)
    if not trace:
        values = {pipe.UNIT: work / window_s, "setup_s": setup_s}
        for m in entries:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        events = device_events(prof) if prof is not None else []
        merged = busy_intervals(events, w0_ns, w1_ns)
        busy_s = sum(b - a for a, b in merged) / 1e9
        ctx = SimpleNamespace(
            cell=cell, config=cfg, traffic=traffic, info=c.layer_info(),
            spans=list(spans.items), events=events, busy_s=busy_s,
            window_s=window_s, samples=n, work=work)
        for m in entries:
            v = reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info = {"busy_s": busy_s, "window_s": window_s}
        if events:
            ops, gaps = breakdown(events, merged, spans.items, w0_ns, w1_ns)
            extra["breakdown"] = {"device_ops": ops, "idle_gaps": gaps}

    c.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    compared = c.check(n)
    log(f"check: {time.perf_counter() - t:.1f} s; "
        + json.dumps(c.info(n)))
    controlled = c.check(n, control=True) if control else None
    bad = [x for x in compared if not x[1] <= x[2]]
    result = {
        "correct": not bad,
        "attempted": n,
        "failed": len(bad),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(peak),
            **dev_info,
        },
        **extra,
        "compared": {name: {"value": v, "limit": lim}
                     for name, v, lim in compared},
    }
    return result, compared, controlled


def card_note() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = os.getcwd()
    bench, cell, _cfg, _tr = load_cell(root, a.workload)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{a.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    torch.zeros(1, device="cuda:0")
    log(f"python, torch and the card's context: "
        f"{time.perf_counter() - t_start:.2f} s")
    result, compared, _ = run_cell(root, a.workload, a.seed, a.seconds,
                                   bool(a.trace), "cuda:0", t_start)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the port must not load JAX or the "
            "JAX package")
        return 3
    log(f"card: {card_note()}")
    for name, v, lim in compared:
        print(f"{name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    sys.exit(main())
