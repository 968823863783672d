"""soibean samples through the k-sweep, as a user runs them one after another.

A sample is `BatchedMapper.map_reads_table` -> `soibean.analyse_table` ->
`soibean_runner.run_soibean_inference(write_files=False)`: reads in
memory to the per-k, per-chain estimates, the signature nodes found
from the data, every k from 1 to their number run as one batch of
k x chains rows through `tree_mcmc.run_tree_mcmc_ksweep`. Its work is
the chain rows times the iterations each runs, burn-in included.

The harness watches the k-sweep from outside (it wraps the module's
`run_tree_mcmc_ksweep` and keeps its starts, its rows' seeds and what it
returns for the samples it checks); nothing of the program is changed.
"""
from __future__ import annotations

import time

import numpy as np

from .. import world as W
from .graphs import program_graph, program_reads
from ..reference import align as ra
from ..reference import soibean_ref as ref
from ..reference.noise import POST_BURN_HOPS, RowNoise

UNIT = "mcmc_steps_per_s"


class Cell:
    """One run's world, reads and program objects, built from the seed."""

    def __init__(self, cfg, traffic, seed, device, log):
        self.cfg, self.traffic, self.seed, self.log = cfg, traffic, seed, log
        self.device = device
        t0 = time.perf_counter()
        # the family's DB is the deployment's, fixed by the configuration;
        # the seed draws the samples' reads and the chains' seeds
        self.tree_world = W.random_tree(cfg["leaves"], cfg["tree_seed"])
        self.world, private = W.build_tree_world(
            self.tree_world, cfg["backbone_bp"], cfg["sites_per_unit"],
            cfg["node_len"], cfg["graph_seed"])
        self.path_names = [p[0] for p in self.world.paths]
        # the planted sources: the leaves with the most private variants
        leaves = [n for n in self.path_names
                  if n not in self.tree_world[1]]
        self.planted = sorted(leaves, key=lambda n: (-private[n], n))[
            :len(traffic["shares"])]
        n = traffic["reads_per_sample"]
        counts = [int(round(s * n)) for s in traffic["shares"]]
        counts[0] += n - sum(counts)
        self.mix = [(self.path_names.index(p), c)
                    for p, c in zip(self.planted, counts)]
        rr = np.random.default_rng([seed, 0x5EAD])
        self.reads = [self._sample_reads(rr)
                      for _ in range(traffic["samples"] + 1)]
        self.sample_seeds = [int(x) for x in rr.integers(0, 2**31, size=len(
            self.reads))]
        # which samples the check reads in full: two of the first four
        self.full_check = sorted(int(x) for x in np.random.default_rng(
            [seed, 0xC4EC]).choice(4, size=2, replace=False))
        self.kept = {}
        self.shapes = []
        log(f"world and {len(self.reads)} samples' reads: "
            f"{time.perf_counter() - t0:.2f} s")

        from vgan_tpu_torch.infer import tree_mcmc as tm
        from vgan_tpu_torch.mapper.giraffe import BatchedMapper
        from vgan_tpu_torch.pipelines import soibean as sb
        from vgan_tpu_torch.pipelines.soibean_runner import \
            run_soibean_inference
        from vgan_tpu_torch.utils.newick import parse_newick

        self._sb, self._infer = sb, run_soibean_inference
        self.graph = program_graph(self.world)
        self.tree = parse_newick(self.tree_world[0])
        self.freqs = sb.make_freqs(*cfg["base_freqs"])
        self.mapper = BatchedMapper(self.graph, k=cfg["k"], w=cfg["w"],
                                    device=device)
        self._watch(tm)
        log(f"graph ({self.graph.n_nodes} nodes, {self.graph.n_paths} "
            f"paths), tree and index: {time.perf_counter() - t0:.2f} s")

    def _sample_reads(self, rng):
        t = self.traffic
        return W.sample_reads(self.world, self.mix, t["read_len"],
                              t["error_rate"], t["qual_lo"], t["qual_hi"],
                              rng)

    def _watch(self, tm):
        """Wrap the k-sweep so that each sample's batch shape is noted
        and the checked samples' inputs and traces are kept."""
        inner = getattr(tm.run_tree_mcmc_ksweep, "__wrapped__",
                        tm.run_tree_mcmc_ksweep)
        cell = self

        def ksweep(*args, **kw):
            out = inner(*args, **kw)
            sources = [np.array(s) for s in args[3]]
            cell._last = dict(sources=sources,
                              init_logls=[float(x) for x in kw["init_logls"]],
                              seeds=[np.array(x) for x in kw["seeds_per_k"]],
                              max_iter=kw["max_iter"], burn=kw["burn"],
                              num_paths=kw["num_paths"], device=kw["device"],
                              traces=out)
            return out

        ksweep.__wrapped__ = inner
        tm.run_tree_mcmc_ksweep = ksweep

    # ------------------------------------------------------------ the sample
    def _reads(self, i):
        """Sample i's reads: set-up makes `samples` of them and a longer
        window takes them again in turn."""
        return self.reads[i % (len(self.reads) - 1)] if i >= 0 \
            else self.reads[-1]

    def _sample(self, i, n_iter, burnin, span):
        reads = program_reads(self._reads(i), f"s{i}_")
        self._last = None
        with span("sample.map"):
            table = self.mapper.map_reads_table(reads)
        with span("sample.analyse"):
            stats = self._sb.analyse_table(self.graph, table,
                                           penalty=self.cfg["penalty"])
        with span("sample.mcmc"):
            res = self._infer(
                self.tree, stats, self.graph.path_names, self.freqs, "",
                n_iter=n_iter, burnin=burnin, chains=self.cfg["chains"],
                seed=self.sample_seeds[i % (len(self.sample_seeds) - 1)],
                write_files=False,
                device=self.device)
        return table, stats, res

    def warm_up(self, span):
        """One short sample on reads of its own: the mapper's chunk
        shapes, both walk lengths of the tree kernel, the summaries."""
        t0 = time.perf_counter()
        w = self.cfg["warm_up_iterations"]
        self._sample(-1, w, w // 3, span)
        self.log(f"warm-up sample: {time.perf_counter() - t0:.2f} s")

    def run_sample(self, i, span) -> float:
        table, stats, res = self._sample(i, self.cfg["iterations"],
                                         self.cfg["burnin"], span)
        last = self._last
        rows = sum(len(s) for s in last["sources"]) if last else 0
        Kmax = max((s.shape[1] for s in last["sources"]), default=0) \
            if last else 0
        self.shapes.append(dict(
            rows=rows, kmax=Kmax,
            active=sum(s.size for s in last["sources"]) if last else 0,
            reads=len(stats.names), paths=len(self.path_names),
            count_bytes=1 if stats.counts25.max(initial=0) <= 255 else 8,
            iterations=self.cfg["iterations"] + 1,
            burn_steps=self.cfg["burnin"] + 1))
        if i in self.full_check or i == 0:
            self.kept[i] = dict(table=table, stats=stats, results=res,
                                ksweep=last)
        else:
            self.kept.setdefault("tables", {})[i] = table
        return float(rows * (self.cfg["iterations"] + 1))

    def release(self):
        """Drop the program's objects that hold the card's memory."""
        self.mapper = None

    # -------------------------------------------------------------- the check
    def check(self, n_done, control=False):
        """[(name, value, limit)] for the samples the seed picks (two of
        the first four, in full) and the alignments of every other
        finished sample. `control`: the reference in float32 stands in
        for the program's statistics, log-likelihoods and estimates."""
        lim = self.cfg["limits"]
        full = [i for i in self.full_check if i < n_done] or [0]
        g = ra.RefGraph(self.world, self.path_names)
        rtree = ref.RefTree(self.tree_world, self.tree.names, self.path_names)
        freq = ref.make_freqs(*self.cfg["base_freqs"])
        rng = np.random.default_rng([self.seed, 0x57E9])
        L = self.traffic["read_len"]
        out = dict(align_bad=0, unmapped=0, stats_gap=0.0, start_bad=0,
                   ll_gap=0.0, state_bad=0, frozen_rows=0, estimate_gap=0.0,
                   summary_gap=0.0, step_bad=0, step_gap=0.0)
        # the tree the program parsed is the world's tree
        kids = [[int(c) for c in row[:n]] for row, n in
                zip(self.tree.children, self.tree.n_children)]
        if (np.any(self.tree.parent != rtree.parent)
                or np.any(np.abs(self.tree.dist - rtree.dist) > 0)
                or kids != rtree.children):
            out["start_bad"] += 1
        tables = dict(self.kept.get("tables", {}))
        for i in full:
            tables[i] = self.kept[i]["table"]
        alns_of = {}
        for i, table in sorted(tables.items()):
            rd = self._reads(i)
            alns = ra.table_alignments(table)
            alns_of[i] = alns
            for j, a in enumerate(alns):
                bad = ra.alignment_fault(g, a, rd.seqs[j],
                                          int(rd.start[j]),
                                          bool(rd.reverse[j]), L)
                if bad == "unmapped":
                    out["unmapped"] += 1
                elif bad is not None:
                    out["align_bad"] += 1
                if bad is not None and out["align_bad"] + out["unmapped"] <= 3:
                    self.log(f"sample {i} read {j}: {bad}")
        for i in full:
            self._check_full(i, alns_of[i], g, rtree, freq, rng, out,
                             control)
        names = ("align_bad", "unmapped", "stats_gap", "start_bad", "ll_gap",
                 "state_bad", "frozen_rows", "estimate_gap", "summary_gap",
                 "step_bad", "step_gap")
        return [(n, out[n], lim[n]) for n in names]

    def _check_full(self, i, alns, g, rtree, freq, rng, out, control):
        k = self.kept[i]
        rd = self._reads(i)
        t0 = time.perf_counter()
        pm, c25, keep = ref.read_stats(g, alns, rd.quals,
                                       [len(s) for s in rd.seqs],
                                       self.cfg["penalty"])
        stats = k["stats"]
        if control:
            pm32, c2532, _ = ref.read_stats(g, alns, rd.quals,
                                            [len(s) for s in rd.seqs],
                                            self.cfg["penalty"], np.float32)
            out["stats_gap"] = max(out["stats_gap"], ref.stats_gap(
                pm32, c2532, pm, c25))
        else:
            out["stats_gap"] = max(out["stats_gap"], ref.stats_gap(
                stats.path_map, stats.counts25, pm, c25))
        self.log(f"sample {i}: reference statistics of {len(keep)} reads "
                 f"in {time.perf_counter() - t0:.1f} s")
        ks = k["ksweep"]
        sig = ref.signature_paths(pm, self.path_names, len(keep))
        node_of = {n: j for j, n in enumerate(self.tree.names)}
        if ks is None or len(ks["sources"]) != len(sig):
            out["start_bad"] += 1
            return
        dtype = np.float32 if control else np.float64
        for kk, (srcs, ll0) in enumerate(zip(ks["sources"], ks["init_logls"])):
            want = [node_of[n] for n in sig[:kk + 1]]
            if list(srcs[0]) != want:
                out["start_bad"] += 1
            cols = [self.path_names.index(n) for n in sig[:kk + 1]]
            ll_ref = ref.initial_log_like(pm, cols)
            got = ref.initial_log_like(pm.astype(dtype), cols) if control \
                else ll0
            out["ll_gap"] = max(out["ll_gap"], ref.rel_gap(got, ll_ref))
        steps = self.cfg["ll_steps_per_row"]
        t_all, t_steps = time.perf_counter(), 0.0
        for kk, tr in enumerate(ks["traces"]):
            C, S, K = tr.node.shape
            mask = np.ones((1, K), dtype=bool)
            for c in range(C):
                node, pos, theta, ll = (tr.node[c], tr.pos[c], tr.theta[c],
                                        tr.loglike[c])
                bad = ((node < 0) | (node >= len(self.tree.names))).any(1)
                bad |= ~((pos > 0) & (pos < 1)).all(1)
                bad |= ~(theta >= 0).all(1)
                bad |= np.abs(theta.sum(1) - 1.0) > 1e-9
                bad |= ~np.isfinite(ll)
                out["state_bad"] += int(bad.sum())
                if (np.all(node == node[0]) and np.all(pos == pos[0])
                        and np.all(theta == theta[0])):
                    out["frozen_rows"] += 1
                js = np.unique(np.concatenate([
                    [0, S - 1], rng.integers(0, S, size=steps)]))
                want = ref.log_like(rtree, pm, c25, freq, node[js], pos[js],
                                    theta[js], np.repeat(mask, len(js), 0))
                got = ref.log_like(rtree, pm.astype(dtype), c25, freq,
                                   node[js], pos[js], theta[js],
                                   np.repeat(mask, len(js), 0), dtype) \
                    if control else ll[js]
                out["ll_gap"] = max(out["ll_gap"], ref.rel_gap(got, want))
                s = k["results"][kk + 1][c]
                mt, vt, mp, vp, mx = ref.estimates(theta, pos, ll)
                if control:
                    gt = ref.estimates(theta, pos, ll, np.float32)
                else:
                    gt = (s.theta_mean, s.theta_var, s.pos_mean, s.pos_var,
                          s.max_loglike)
                    if list(s.source_names) != [self.tree.names[x]
                                                for x in node[-1]]:
                        out["state_bad"] += 1
                for a, b in zip(gt, (mt, vt, mp, vp, mx)):
                    out["estimate_gap"] = max(out["estimate_gap"],
                                              ref.rel_gap(a, b, 1e-12))
                out["summary_gap"] = max(out["summary_gap"], self._summaries(
                    rtree, node, pos, theta, s, control))
                t0 = time.perf_counter()
                self._steps(ks, kk, c, rtree, pm, c25, freq, rng, out,
                            control)
                t_steps += time.perf_counter() - t0
        self.log(f"sample {i}: summaries and steps checked in "
                 f"{time.perf_counter() - t_all:.1f} s (steps {t_steps:.1f} s)")

    def _summaries(self, rtree, node, pos, theta, s, control):
        """The widest gap of a chain's printed summaries (quantiles, ESS,
        lag-1 autocorrelation, the patristic series' ESS) from the
        reference's, beyond the printing's rounding, relative."""
        want = ref.chain_summaries(rtree, node, pos, theta)
        if control:
            got = [[[f"{v:.6g}" for v in row] for row in src] for src in
                   ref.chain_summaries(rtree, node, pos, theta, np.float32)]
        else:
            if len(s.est_lines) != len(want):
                return float("inf")
            got = [[e.split("\t")[2:], b.split("\t")[2:]]
                   for e, b in zip(s.est_lines, s.branch_lines)]
        gap = 0.0
        for g_src, w_src in zip(got, want):
            for g_row, w_row in zip(g_src, w_src):
                if len(g_row) != len(w_row):
                    return float("inf")
                gap = max([gap] + [ref.printed_excess(a, b)
                                   for a, b in zip(g_row, w_row)])
        return gap

    def _steps(self, ks, kk, c, rtree, pm, c25, freq, rng, out, control):
        """Replays drawn recorded steps of chain row (k, c): the
        reference's move from the recorded state on the row's own noise
        must give the next recorded state."""
        tr = ks["traces"][kk]
        node, pos, theta, ll = (tr.node[c], tr.pos[c], tr.theta[c],
                                tr.loglike[c])
        S, K = node.shape
        kmax = max(x.shape[1] for x in ks["sources"])
        burn = ks["burn"]
        noise = RowNoise(ks["seeds"][kk][c], kmax, POST_BURN_HOPS,
                         ks["device"])
        js = np.unique(np.concatenate([
            [0, S - 2], rng.integers(0, S - 1,
                                     size=self.cfg["steps_per_row"])]))
        for j in js:
            it = burn + 1 + int(j)
            sd = ref.sd_at(it, ks["max_iter"], burn, ks["num_paths"])
            delta, walk_u, trunc_u, acc_u = noise.at(it)
            nz = (delta[:K], walk_u[:K], trunc_u[:K], acc_u)
            state = (node[j], pos[j], theta[j])
            want, other = _next(rtree, pm, c25, freq, state, nz, sd)
            if control:
                got, _ = _next(rtree, pm, c25, freq, state, nz, sd,
                               np.float32)
            else:
                got = (node[j + 1], pos[j + 1], theta[j + 1], ll[j + 1])
            gap_w, gap_o = _state_gap(got, want), _state_gap(got, other)
            if gap_o < gap_w:
                out["step_bad"] += 1
            out["step_gap"] = max(out["step_gap"], gap_w)

    # -------------------------------------------------------- for the readers
    def layer_info(self):
        return dict(shapes=self.shapes)

    def info(self, n_done):
        """What the planted sources came out as (not compared)."""
        k = self.kept.get(0)
        if not k:
            return {}
        res = k["results"].get(len(self.planted))
        if not res:
            return {}
        best = max(res, key=lambda s: s.max_loglike)
        return {"k3_best_chain": dict(zip(best.source_names,
                                          [round(x, 4) for x in best.theta_mean])),
                "planted": dict(zip(self.planted, self.traffic["shares"]))}


def _next(rtree, pm, c25, freq, state, noise, sd, dtype=np.float64):
    """(the state after one step from `state` = (nodes, pos, theta) on
    `noise`, and the one the step did not take), each as (nodes, pos,
    theta, ll), computed by the reference in `dtype`."""
    node = state[0]
    pos, theta = (np.asarray(x, dtype=dtype) for x in state[1:])
    pmd = pm.astype(dtype, copy=False)
    ll = ref.log_like(rtree, pmd, c25, freq, node[None], pos[None],
                      theta[None], np.ones((1, len(node)), bool), dtype)[0]
    prop, acc = ref.step(rtree, pmd, c25, freq, node, pos, theta, ll,
                         noise, sd, dtype)
    cur = (node, pos, theta, ll)
    return (prop, cur) if acc else (cur, prop)


def _state_gap(a, b) -> float:
    """How far chain state a = (nodes, pos, theta, ll) lies from b: inf
    on other nodes, else the widest gap of a position or a proportion,
    or of the log-likelihood relative to b's."""
    if not np.array_equal(np.asarray(a[0]), np.asarray(b[0])):
        return float("inf")
    d = max(float(np.abs(np.asarray(a[1], np.float64) - b[1]).max()),
            float(np.abs(np.asarray(a[2], np.float64) - b[2]).max()))
    return max(d, ref.rel_gap(a[3], b[3]))
