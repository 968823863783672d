# Copied from vgan_tpu/pipelines/euka_runner.py; imports repointed to this package, the MCMC given a device.
"""euka end-to-end driver and output writers.

Output schemas mirror `src/Euka.cpp:585-1184`:
  <out>_abundance.tsv  all taxa, detected yes/no, counts, estimates (+CIs)
  <out>_detected.tsv   detected taxa only
  <out>_coverage.tsv   per-taxon 21-bin fractional coverage + entropy
  <out>_inSize.tsv     per-taxon fragment sizes
  <out>_FragNames.tsv  per-taxon read names (--outFrag)
  <out>_<taxon>.prof   per-taxon baseshift substitution rates
  <out>_5p.prof/_3p.prof averaged C>T / G>A profiles for a second pass
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..infer.abundance_mcmc import AbundanceResult, run_mcmc_checkpointed
from .euka import EukaResult, compute_init_vec


def abundance_mcmc_from_result(
    res: EukaResult, n_iter: int = 10000, burnin: int = 100, seed: int = 0,
    checkpoint_path: Optional[str] = None, checkpoint_every: int = 100000,
    *, device,
) -> Optional[AbundanceResult]:
    if len(res.detected) < 2:
        return None
    n_reads = np.array([len(res.clade_like[i]) for i in res.detected])
    slog = np.array(
        [
            np.sum(np.log(np.maximum(res.clade_like[i], 0.0)))
            if all(x > 0 for x in res.clade_like[i])
            else -np.inf
            for i in res.detected
        ]
    )
    init = compute_init_vec(res.counts, res.detected)
    return run_mcmc_checkpointed(
        n_reads, slog, init, n_iter=n_iter, burnin=burnin, seed=seed,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        device=device,
    )


def write_outputs(
    res: EukaResult,
    out: str,
    mcmc: Optional[AbundanceResult] = None,
    length_to_prof: int = 5,
    out_frag: bool = False,
) -> None:
    init = compute_init_vec(res.counts, res.detected)
    with_ci = mcmc is not None
    header = "#Taxa\tdetected\tNumber_of_reads\tproportion_estimate"
    if with_ci:
        header += (
            "\t85%_confidence_interval_lower_bound"
            "\t85%_confidence_interval_higher_bound"
            "\t95%_confidence_interval_lower_bound"
            "\t95%_confidence_interval_higher_bound"
        )
    ab = open(f"{out}_abundance.tsv", "w")
    det = open(f"{out}_detected.tsv", "w")
    cov = open(f"{out}_coverage.tsv", "w")
    ins = open(f"{out}_inSize.tsv", "w")
    ab.write(header + "\n")
    det.write(header + "\n")
    cov.write(
        "#Taxa\t"
        + "\t".join(f"bin{b}\tentropy" for b in range(21))
        + "\n"
    )
    det_rank = {c: r for r, c in enumerate(res.detected)}
    for i, clade in enumerate(res.clades):
        if i not in det_rank:
            zeros = "\t".join(["0"] * (5 if with_ci else 1))
            ab.write(f"{clade.name}\tno\t{res.counts[i]}\t{zeros}\n")
            continue
        r = det_rank[i]
        if with_ci:
            vals = (
                f"{mcmc.estimate[r]:.6g}\t{mcmc.ci85[r,0]:.6g}\t"
                f"{mcmc.ci85[r,1]:.6g}\t{mcmc.ci95[r,0]:.6g}\t{mcmc.ci95[r,1]:.6g}"
            )
        else:
            vals = f"{init[r]:.6g}"
        line = f"{clade.name}\tyes\t{res.counts[i]}\t{vals}\n"
        ab.write(line)
        det.write(line)
        cov.write(
            clade.name
            + "\t"
            + "\t".join(
                f"{res.coverage[i][j]:.5f}\t{res.chunks[i][j][2]}"
                for j in range(len(res.chunks[i]) - 1)
            )
            + "\n"
        )
        ins.write(
            clade.name + "\t" + "\t".join(map(str, res.insert_sizes[i])) + "\n"
        )
    for f in (ab, det, cov, ins):
        f.close()

    if out_frag:
        with open(f"{out}_FragNames.tsv", "w") as f:
            for i in res.detected:
                f.write(
                    res.clades[i].name + "\t" + "\t".join(res.frag_names[i]) + "\n"
                )

    # per-taxon damage profiles + averaged 5p/3p (`src/Euka.cpp:736-860`)
    ct5, ga3 = [], []
    for i in res.detected:
        rates = _prof_rates(res.baseshift[i], length_to_prof)
        _write_prof(f"{out}_{res.clades[i].name}.prof", rates, length_to_prof)
        ct5.append(rates[:length_to_prof, 5])  # C>T, 5' half
        ga3.append(rates[length_to_prof:, 6])  # G>A, 3' half
    ct5_av = np.mean(ct5, axis=0) if ct5 else np.zeros(length_to_prof)
    ga3_av = np.mean(ga3, axis=0) if ga3 else np.zeros(length_to_prof)
    hdr = "A>C\tA>G\tA>T\tC>A\tC>G\tC>T\tG>A\tG>C\tG>T\tT>A\tT>C\tT>G\n"
    with open(f"{out}_5p.prof", "w") as f:
        f.write(hdr)
        for v in ct5_av:
            row = ["0"] * 12
            row[5] = f"{v:.6g}"
            f.write("\t".join(row) + "\n")
    with open(f"{out}_3p.prof", "w") as f:
        f.write(hdr)
        for v in ga3_av[::-1]:
            row = ["0"] * 12
            row[6] = f"{v:.6g}"
            f.write("\t".join(row) + "\n")


def _prof_rates(counts: np.ndarray, ltp: int) -> np.ndarray:
    """[2*ltp, 12] substitution rates: count(i->j)/count(i->*)
    (`src/baseshift.cpp:144-230`)."""
    out = np.zeros((2 * ltp, 12), dtype=np.float64)
    for p in range(2 * ltp):
        col = 0
        for i in range(4):
            denom = counts[p, i * 4 : i * 4 + 4].sum()
            for j in range(4):
                if i != j:
                    out[p, col] = counts[p, i * 4 + j] / denom if denom else 0.0
                    col += 1
    return out


def _write_prof(path: str, rates: np.ndarray, ltp: int) -> None:
    hdr = "A>C\tA>G\tA>T\tC>A\tC>G\tC>T\tG>A\tG>C\tG>T\tT>A\tT>C\tT>G\tPosition\n"
    with open(path, "w") as f:
        f.write(hdr)
        for p in range(2 * ltp):
            pos = p if p < ltp else -(2 * ltp) + p
            f.write(
                "\t".join(f"{x:.4g}" for x in rates[p]) + f"\t{pos}\n"
            )
            if p == ltp - 1:
                f.write(hdr)
