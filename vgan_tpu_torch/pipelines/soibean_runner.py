# Port of vgan_tpu/pipelines/soibean_runner.py: the host logic copied, the chains given a device (or a list of them, the mesh's chain split), the patristic-distance series on the card, traced by PROFILER's spans.
"""soibean end to end: map -> stats -> chains -> outputs.

Output files mirror the reference exactly (`src/soibean.cpp:745-940`,
`src/MCMC.cpp:23-147,553-566`):
  <out>Result<k><chain>.mcmc      gzip trace (accepted-state trace)
  <out>Trace<k><chain>.detail.mcmc gzip trace incl. rejected proposals
  <out>ProportionEstimates<k>.txt  per source/chain theta stats
  <out>BranchEstimate<k>.txt       per source/chain position stats
  <out>Diagnostics<k><chain>.txt   R-hat across chains
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..infer import diagnostics as dg
from ..infer import patristic as pt
from ..infer import tree_mcmc as tm
from ..infer.tree_mcmc import MCMCTrace
from ..utils.newick import Tree
from ..utils.profiling import PROFILER
from . import soibean as sb


@dataclass
class ChainSummary:
    source_names: List[str]
    theta_mean: List[float]
    theta_var: List[float]
    pos_mean: List[float]
    pos_var: List[float]
    max_loglike: float
    # formatted rows for the shared ProportionEstimates/BranchEstimate
    # files (multi-process: host 0 writes them in chain order)
    est_lines: List[str] = None
    branch_lines: List[str] = None


def _append_shared_estimates(out_prefix, k, est_lines, branch_lines):
    """Append one chain's rows to the shared per-k estimate files
    (header once)."""
    import os

    eh = ("Source\tChain\tMean Proportion Estimate\t5% CI\tMedian "
          "Proportion Estimate\t95% CI\tEffective Sample Size\t"
          "Autocorrelation\tVariance\n")
    bh = ("Source\tChain\tMean Branch Position\t5% CI\tMedian Branch "
          "Position\t95% CI\tEffective Sample Size\tAutocorrelation\t"
          "Variance\tEffective Sample Size for the source estimation\n")
    for path, header, lines in [
        (f"{out_prefix}ProportionEstimates{k}.txt", eh, est_lines),
        (f"{out_prefix}BranchEstimate{k}.txt", bh, branch_lines),
    ]:
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write(header)
            f.write("\n".join(lines) + "\n")


@PROFILER.traced("soibean.chain")
def process_chain(
    trace: MCMCTrace,
    tree: Tree,
    k: int,
    out_prefix: str,
    chain: int,
    write_files: bool = True,
    write_shared: bool = True,
    device=None,
) -> ChainSummary:
    """processMCMCiterations equivalent (`src/MCMC.cpp:23-147`). A
    `soibean.chain` span; each source's steps are `summaries.*` spans,
    the files a `soibean.write` span.

    device: where a source's patristic-distance series is computed. A
    CUDA device runs infer/patristic's kernel on the tree's cached
    tables; None or the CPU the held host function, as the JAX package
    does. Both give the same bits."""
    on_card = device is not None and torch.device(device).type != "cpu"
    est_lines = []
    branch_lines = []
    names: List[str] = []
    tmeans, tvars, pmeans, pvars = [], [], [], []
    max_ll = float(trace.loglike.max()) if len(trace.loglike) else float("nan")
    for s in range(k):
        theta = trace.theta[:, s]
        pos = trace.pos[:, s]
        final_node = int(trace.node[-1, s])
        name = tree.names[final_node]
        names.append(name)
        with PROFILER.span("summaries.moments"):
            mt, mp = dg.mean(theta), dg.mean(pos)
            vt, vp = dg.variance(theta, mt), dg.variance(pos, mp)
            at, ap = dg.autocorrelation(theta, 1), dg.autocorrelation(pos, 1)
        with PROFILER.span("summaries.ess"):
            et = dg.effective_sample_size(theta)
            ep = dg.effective_sample_size(pos)
        with PROFILER.span("summaries.patristic"):
            # branch-level ESS from the patristic-distance series
            if on_card:
                euc = pt.patristic_distance_series(
                    pt.patristic_tables(tree), trace.node[:, s], pos, device)
            else:
                euc = dg.patristic_distance_series(tree, trace.node[:, s],
                                                   pos)
            ed = dg.effective_sample_size(euc)
        with PROFILER.span("summaries.quantiles"):
            st, sp = np.sort(theta), np.sort(pos)
            est_lines.append(
                f"{name}\t{chain}\t{mt:.6g}\t{dg.quantile(st, 0.05):.6g}\t"
                f"{dg.quantile(st, 0.5):.6g}\t{dg.quantile(st, 0.95):.6g}\t"
                f"{et:.6g}\t{at:.6g}\t{vt:.6g}"
            )
            branch_lines.append(
                f"{name}\t{chain}\t{mp:.6g}\t{dg.quantile(sp, 0.05):.6g}\t"
                f"{dg.quantile(sp, 0.5):.6g}\t{dg.quantile(sp, 0.95):.6g}\t"
                f"{ep:.6g}\t{ap:.6g}\t{vp:.6g}\t{ed:.6g}"
            )
        tmeans.append(mt)
        tvars.append(vt)
        pmeans.append(mp)
        pvars.append(vp)
    if write_files:
        with PROFILER.span("soibean.write"):
            if write_shared:
                _append_shared_estimates(out_prefix, k, est_lines,
                                         branch_lines)
            _write_chain_traces(trace, tree, k, out_prefix, chain)
    return ChainSummary(names, tmeans, tvars, pmeans, pvars, max_ll,
                        est_lines, branch_lines)


def _write_chain_traces(trace: MCMCTrace, tree: Tree, k: int,
                        out_prefix: str, chain: int) -> None:
    """A chain's two gzip traces (`src/MCMC.cpp:1022-1056`)."""
    # detail trace with move markers (state change => accepted;
    # the reference logs proposals pre-accept, `src/MCMC.cpp:1022-1056`)
    with gzip.open(f"{out_prefix}Trace{k}{chain}.detail.mcmc", "wt") as f:
        f.write(
            "".join(
                f"Source_{s2+1}\tLog-likelihood\tproportion_{s2+1}\t"
                f"branch_position_derived_{s2+1}\tMove\t"
                for s2 in range(k)
            )
            + "\n"
        )
        for it in range(1, len(trace.loglike)):
            moved = trace.loglike[it] != trace.loglike[it - 1]
            mark = "accepted" if moved else "rejected"
            row = []
            for s2 in range(k):
                row.append(
                    f"{tree.names[int(trace.node[it, s2])]}\t"
                    f"{trace.loglike[it]:.14g}\t{trace.theta[it, s2]:.14g}\t"
                    f"{trace.pos[it, s2]:.14g}\t{mark}"
                )
            f.write("\t".join(row) + "\n")
    # gzip trace of recorded states
    with gzip.open(f"{out_prefix}Result{k}{chain}.mcmc", "wt") as f:
        f.write(
            "".join(
                f"Source_{s+1}\tLog-likelihood\tproportion\tbranch_position_derived\t"
                for s in range(k)
            )
            + "\n"
        )
        for it in range(len(trace.loglike)):
            row = []
            for s in range(k):
                row.append(
                    f"{tree.names[int(trace.node[it, s])]}\t"
                    f"{trace.loglike[it]:.14g}\t{trace.theta[it, s]:.14g}\t"
                    f"{trace.pos[it, s]:.14g}"
                )
            f.write("\t".join(row) + "\n")


@PROFILER.traced("soibean.inference")
def run_soibean_inference(
    tree: Tree,
    stats: sb.ReadStats,
    path_names: List[str],
    freqs: Dict[str, float],
    out_prefix: str,
    n_iter: int = 500000,
    burnin: int = 75000,
    chains: int = 4,
    specified_k: Optional[int] = None,
    seed: int = 0,
    write_files: bool = True,
    rand_start: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 100000,
    *,
    device,
    devices=None,
) -> Dict[int, List[ChainSummary]]:
    """Full inference loop over k = 1..#signature nodes x chains
    (`src/soibean.cpp:745-940`), the chains on `device`.

    devices, a list: the chain rows split over them when the chain
    count divides evenly (the reference runs chains in turn,
    `src/soibean.cpp:805-840`). Under multi-process, rank p runs the
    chains c with c % nproc == p (every rank draws the same starts and
    seeds, and a row's noise is its own), writes those chains' trace
    files, and the chain summaries are gathered for host 0's shared
    estimate files and the cross-chain R-hat.

    The whole sweep (k = 1..K x chains) runs as ONE batch of K*C chain
    rows (`run_tree_mcmc_ksweep`: one CUDA thread-block cluster a row
    on the card); the reference runs each k and chain in turn.

    checkpoint_path: when set, chains run through the segmented
    resumable sampler; state snapshots to
    `<checkpoint_path>.k<k>.c<chain>.npz` every `checkpoint_every`
    iterations and an interrupted run continues from the last snapshot
    (SURVEY §5 checkpoint/resume — the reference restarts from zero).

    Traced as the `soibean.inference` span: `soibean.prepare` (starts,
    initial log-likelihoods, the upload), the sampler's
    `tree_mcmc.sweep`, a `soibean.summaries` span a k and
    `soibean.write`."""
    with PROFILER.span("soibean.prepare"):
        tree_index = tree.name_to_index()
        # map graph path columns onto tree node order
        name_of_col = path_names
        col_of_tree = np.zeros(tree.n_nodes, dtype=np.int64)
        for i, nm in enumerate(tree.names):
            col_of_tree[i] = name_of_col.index(nm) if nm in name_of_col else 0
        path_map_t = stats.path_map[:, col_of_tree]
        counts25_t = stats.counts25[:, col_of_tree, :]

        # con = shortest nonzero branch < 1, else 0.01
        # (`src/soibean.cpp:595-599`)
        nz = tree.dist[(tree.dist != 0.0) & (tree.dist < 1.0)]
        con = float(nz.min()) if len(nz) else 0.01

        if specified_k is not None:
            rng = np.random.default_rng(seed)
            sig_nodes = list(rng.integers(0, tree.n_nodes, size=specified_k))
            sig_paths = [tree.names[i] for i in sig_nodes]
        else:
            sig_nodes, sig_paths = sb.signature_nodes(
                stats, path_names, tree_index
            )
            if not sig_nodes:
                rng = np.random.default_rng(seed)
                sig_nodes = list(rng.integers(0, tree.n_nodes, size=3))
                sig_paths = [tree.names[i] for i in sig_nodes]

        results: Dict[int, List[ChainSummary]] = {}
        rng = np.random.default_rng(seed + 1)
        # per-k chain inits up front: chain 0 starts at the signature
        # nodes, later chains random (`src/soibean.cpp:808-811`)
        per_k: List[tuple] = []
        for i in range(len(sig_nodes)):
            k = i + 1
            sub_paths = sig_paths[: i + 1]
            init_ll = sb.initial_log_like(
                stats,
                [name_of_col.index(p) for p in sub_paths if p in name_of_col]
            )
            srcs = np.zeros((chains, k), dtype=np.int32)
            if rand_start:
                # --randStart: every chain starts at random tree nodes
                # instead of the signature nodes (`src/soibean.cpp:806-811`)
                srcs[0] = rng.integers(0, tree.n_nodes, size=k)
            else:
                srcs[0] = np.array(sig_nodes[: i + 1], dtype=np.int32)
            for chain in range(1, chains):
                srcs[chain] = rng.integers(0, tree.n_nodes, size=k)
            seeds = np.arange(chains) + seed * 1000 + k * 10
            per_k.append((k, srcs, seeds, init_ll))

        # multi-process chain parallelism: every rank draws the same
        # srcs/seeds (shared seed), runs its round-robin chain subset, then
        # the summaries allgather for the cross-chain R-hat
        from ..parallel import multihost

        if multihost.active() and multihost.process_count() > 1:
            nproc = multihost.process_count()
            pid = multihost.process_id()
            local_ids = [c for c in range(chains) if c % nproc == pid]
        else:
            nproc, pid = 1, 0
            local_ids = list(range(chains))
        chain_devices = None
        if nproc == 1 and devices is not None and chains % len(devices) == 0:
            chain_devices = list(devices)

        # path-major path_map / counts25 on the device, once for the run
        data = tm.prepare(tree, path_map_t, counts25_t, freqs, con, device)
    ksweep_traces = None
    if checkpoint_path is None and len(per_k) > 1 and local_ids:
        ksweep_traces = tm.run_tree_mcmc_ksweep(
            tree, data, None, [srcs[local_ids] for _k, srcs, _s, _l in per_k],
            freqs, con=con, max_iter=n_iter, burn=burnin,
            num_paths=len(path_names),
            init_logls=[ll for *_x, ll in per_k],
            seeds_per_k=[s[local_ids] for _k, _srcs, s, _l in per_k],
            device=device, devices=chain_devices,
        )

    for i, (k, srcs, seeds, init_ll) in enumerate(per_k):
        if write_files and (nproc == 1 or multihost.is_host0()):
            # the shared per-k estimate files append per chain; start
            # each k from a clean slate so an interrupted run resumed
            # via --checkpoint (or a plain rerun) never double-appends
            import os as _os

            for p in (
                f"{out_prefix}ProportionEstimates{k}.txt",
                f"{out_prefix}BranchEstimate{k}.txt",
            ):
                if _os.path.exists(p):
                    _os.unlink(p)
        if checkpoint_path is not None:
            per_chain = [
                tm.run_tree_mcmc_checkpointed(
                    tree,
                    data,
                    None,
                    srcs[chain],
                    freqs,
                    con=con,
                    max_iter=n_iter,
                    burn=burnin,
                    num_paths=len(path_names),
                    init_loglike=init_ll,
                    seed=int(seeds[chain]),
                    checkpoint_path=f"{checkpoint_path}.k{k}.c{chain}.npz",
                    checkpoint_every=checkpoint_every,
                    device=device,
                )
                for chain in local_ids
            ]
            traces = MCMCTrace(
                node=np.stack([t.node for t in per_chain]),
                pos=np.stack([t.pos for t in per_chain]),
                theta=np.stack([t.theta for t in per_chain]),
                loglike=np.stack([t.loglike for t in per_chain]),
            ) if per_chain else None
        elif ksweep_traces is not None:
            traces = ksweep_traces[i]
        elif not local_ids:
            traces = None  # more ranks than chains: this one runs none
        else:
            traces = tm.run_tree_mcmc_chains(
                tree,
                data,
                None,
                srcs[local_ids],
                freqs,
                con=con,
                max_iter=n_iter,
                burn=burnin,
                num_paths=len(path_names),
                init_loglike=init_ll,
                seeds=seeds[local_ids],
                device=device,
                devices=chain_devices,
            )
        with PROFILER.span("soibean.summaries"):
            local_summaries: List[tuple] = []
            for j, chain in enumerate(local_ids):
                trace = type(traces)(
                    node=traces.node[j],
                    pos=traces.pos[j],
                    theta=traces.theta[j],
                    loglike=traces.loglike[j],
                )
                local_summaries.append((
                    chain,
                    process_chain(trace, tree, k, out_prefix, chain,
                                  write_files, write_shared=(nproc == 1),
                                  device=device),
                ))
            if nproc > 1:
                gathered = multihost.allgather_objects(local_summaries)
                pairs = sorted(
                    (p for part in gathered for p in part),
                    key=lambda cs: cs[0],
                )
                summaries = [s for _c, s in pairs]
                if write_files and multihost.is_host0():
                    # shared estimate files in chain order (owners wrote
                    # only their per-chain trace files)
                    with PROFILER.span("soibean.write"):
                        for s in summaries:
                            _append_shared_estimates(
                                out_prefix, k, s.est_lines, s.branch_lines
                            )
            else:
                summaries = [s for _c, s in local_summaries]
        results[k] = summaries
        if write_files and (nproc == 1 or multihost.is_host0()):
            with PROFILER.span("soibean.write"):
                _write_diagnostics(out_prefix, k, summaries, n_iter, burnin)
    return results


def _write_diagnostics(out_prefix, k, summaries: List[ChainSummary],
                       n_iter, burnin):
    chain_len = n_iter - burnin
    with open(f"{out_prefix}Diagnostics{k}0.txt", "w") as f:
        f.write(
            "Source\tHighest log-likelihood\tfor chain\tRhat for the "
            "proportion estimate\tRhat for the branch position estimate\n"
        )
        lls = [s.max_loglike for s in summaries]
        best_chain = int(np.argmax(lls))
        for s_idx, name in enumerate(summaries[0].source_names):
            pr = dg.rhat(
                np.array([c.theta_mean[s_idx] for c in summaries]),
                np.array([c.theta_var[s_idx] for c in summaries]),
                chain_len,
            )
            br = dg.rhat(
                np.array([c.pos_mean[s_idx] for c in summaries]),
                np.array([c.pos_var[s_idx] for c in summaries]),
                chain_len,
            )
            f.write(f"{name}\t{max(lls)}\t{best_chain}\t{pr}\t{br}\n")
