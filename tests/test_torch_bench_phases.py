"""Every phase of the port's bench (vgan_tpu_torch/bench.py) run on the
CPU at bench.py's smoke sizes (soibean's chains cut to 200 iterations to
fit a test's time): its fields are those of bench.py's phase of the same
name, less the two dropped ones, plus a runs list for each best-of-N
field; each metric is finite and above 0 and each agreement flag true."""
import math
from dataclasses import replace

import pytest
import torch

from vgan_tpu_torch import bench

import bench as jax_bench

torch.set_num_threads(1)

SIZES = replace(bench.Sizes.of(True), soibean_iters=200, soibean_burn=50)

# the fields each of bench.py's phases returns (`bench.py:781-918`)
JAX_PHASE_FIELDS = {
    "hc_toy_e2e": ["metric", "value", "unit", "vs_baseline",
                   "host_oracle_e2e_reads_per_s", "workload",
                   "argmax_agrees"],
    "sw": ["sw_kernel_gcups", "sw_vpu_fraction", "backend"],
    "device_step": ["haplocart_device_reads_per_s", "device_vs_numpy",
                    "device_argmax_agrees"],
    "toy_mapping": ["mapping_reads_per_s", "mapping_rate"],
    "euka_toy": ["euka_e2e_reads_per_s"],
    "realdb_mapping": ["hc_realdb_mapping_reads_per_s", "hc_realdb_paths",
                       "hc_realdb_map_chunks",
                       "hc_realdb_map_submit_s_per_chunk",
                       "hc_realdb_map_collect_s_per_chunk",
                       "hc_realdb_map_finalize_s_per_chunk",
                       "hc_realdb_map_wall_s"],
    "hc_realdb": ["hc_realdb_e2e_reads_per_s",
                  "hc_realdb_host_oracle_reads_per_s",
                  "hc_realdb_vs_baseline", "hc_realdb_argmax_agrees"],
    "euka_realdb": ["euka_realdb_e2e_reads_per_s", "euka_realdb_taxa",
                    "euka_realdb_map_reads_per_s",
                    "euka_realdb_score_reads_per_s"],
    "euka_mcmc": ["euka_mcmc_iters_per_s"],
    "soibean_mcmc": ["soibean_mcmc_iters_per_s",
                     "soibean_ksweep_iters_per_s"],
    "soibean_e2e": ["soibean_e2e_reads_per_s", "soibean_map_s",
                    "soibean_precompute_s",
                    "soibean_precompute_reads_per_s", "soibean_mcmc_s",
                    "soibean_mcmc_e2e_iters_per_s",
                    "soibean_mcmc_host_iters_per_s"],
    "keelime": ["keelime_e2e_reads_per_s"],
    "multihost": ["multihost_2proc_wallclock_ratio"],
}
FLAGS = ("argmax_agrees", "hc_realdb_argmax_agrees", "device_argmax_agrees")
TEXT = ("metric", "unit", "workload")


def test_phases_are_bench_pys_in_order():
    assert list(bench.PHASES) == [n for n, _ in jax_bench.PHASES
                                  if n != "hc_toy_e2e_retry"]
    assert list(JAX_PHASE_FIELDS) == list(bench.PHASES)
    every = [f for fs in JAX_PHASE_FIELDS.values() for f in fs]
    assert sorted(every) == sorted(jax_bench.FIELD_ORDER)


def _positive_numbers(x):
    if isinstance(x, dict):
        return all(_positive_numbers(v) for v in x.values())
    if isinstance(x, list):
        return len(x) > 0 and all(_positive_numbers(v) for v in x)
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and math.isfinite(x) and x > 0)


@pytest.mark.parametrize("name", list(bench.PHASES))
def test_phase_fields_equal_bench_pys(name):
    fields = bench.PHASES[name](bench.Bench("cpu", SIZES))
    want = [f for f in JAX_PHASE_FIELDS[name]
            if f not in ("sw_vpu_fraction", "backend")]
    want += [f"{f}_runs_s" for f in want if f in bench.BEST_OF_FIELDS]
    if name == "sw":
        want.append("sw_bound_share")
    assert sorted(fields) == sorted(want)
    for k, v in fields.items():
        if k in FLAGS:
            assert v is True, k
        elif k in TEXT:
            assert isinstance(v, str) and v, k
        else:
            assert _positive_numbers(v), (k, v)
