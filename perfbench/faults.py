"""Faults planted under the harness, to show that the check catches them.

Each is a context manager that patches one function of the program for
as long as it is open; nothing the benchmark's own runs execute uses
this module. The faults are those a soibean sample can have on one card
(there is no exchange between cards to leave out):

* `frozen_step`: every MCMC step returns its state unchanged;
* `half_reads`: the likelihood sums over half of the reads, counted
  twice (the mean of half the batch in place of the whole);
* `half_mapped`: the mapper leaves half of the reads unmapped;
* `altered_alignment`: one read's alignment moved by one node where the
  mapper produces it;
* `altered_loglike`: one recorded log-likelihood of each segment
  altered where the kernel writes it;
* `always_accept`: the kernel accepts every proposal (its accept
  uniforms all 0);
* `zeroed_patristic`: the chains' summaries take a patristic-distance
  series of zeros.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def frozen_step():
    from vgan_tpu_torch.infer import tree_mcmc as tm

    def make(inner):
        def run_segment(nodes, pos, theta, ll, mask, iters, *rest, **kw):
            S = int(iters.shape[0])

            def rec(x):
                return x.unsqueeze(1).expand(
                    (x.shape[0], S) + tuple(x.shape[1:])).contiguous()

            return (nodes, pos, theta, ll), (rec(nodes.int()), rec(pos),
                                             rec(theta), rec(ll))
        return run_segment
    return _patched(tm, "run_segment", make)


def half_reads():
    import torch

    from vgan_tpu_torch.infer import tree_mcmc as tm

    def make(inner):
        def run_segment(nodes, pos, theta, ll, mask, iters, sd, noise,
                        path_map_t, counts25_t, *rest, **kw):
            R = path_map_t.shape[1]
            h = R // 2
            pm = torch.cat([path_map_t[:, :h], path_map_t[:, :R - h]], 1)
            cc = torch.cat([counts25_t[:, :h], counts25_t[:, :R - h]], 1)
            return inner(nodes, pos, theta, ll, mask, iters, sd, noise,
                         pm.contiguous(), cc.contiguous(), *rest, **kw)
        return run_segment
    return _patched(tm, "run_segment", make)


def _chunks_fault(change):
    """Patch the mapper's chunk generator (map_reads_table concatenates
    its chunks) so that every chunk table passes through `change`."""
    from vgan_tpu_torch.mapper.giraffe import BatchedMapper

    def make(inner):
        def map_table_chunks(self, reads, *a, **kw):
            for t in inner(self, reads, *a, **kw):
                yield change(t)
        return map_table_chunks
    return _patched(BatchedMapper, "map_table_chunks", make)


def half_mapped():
    import numpy as np

    from vgan_tpu_torch.io.fastx import Read
    from vgan_tpu_torch.mapper import batch_map

    def change(t):
        h = t.n // 2
        rest = [Read(name=n, seq=s, qual=q) for n, s, q in
                zip(t.names[h:], t.seqs[h:], t.quals[h:])]
        return batch_map.AlignmentTable.concat(
            [t.select(np.arange(h)), batch_map._empty_table(rest)])
    return _chunks_fault(change)


def altered_alignment():
    def change(t):
        if len(t.m_node):
            t.m_node = t.m_node.copy()
            t.m_node[0] += 1
        return t
    return _chunks_fault(change)


def altered_loglike():
    from vgan_tpu_torch.infer import tree_mcmc as tm

    def make(inner):
        def run_segment(*a, **kw):
            carry, (rn, rp, rt, rl) = inner(*a, **kw)
            rl = rl.clone()
            rl[0, rl.shape[1] // 2] += 1e-3 * (1.0 + rl[0, rl.shape[1] // 2].abs())
            return carry, (rn, rp, rt, rl)
        return run_segment
    return _patched(tm, "run_segment", make)


def always_accept():
    from vgan_tpu_torch.infer import tree_mcmc as tm

    def make(inner):
        def run_segment(nodes, pos, theta, ll, mask, iters, sd, noise,
                        *rest, **kw):
            noise = noise._replace(acc_u=noise.acc_u.new_zeros(
                noise.acc_u.shape))
            return inner(nodes, pos, theta, ll, mask, iters, sd, noise,
                         *rest, **kw)
        return run_segment
    return _patched(tm, "run_segment", make)


def zeroed_patristic():
    from vgan_tpu_torch.infer import diagnostics as dg

    def make(inner):
        def patristic_distance_series(tree, nodes, pos):
            return 0.0 * inner(tree, nodes, pos)
        return patristic_distance_series
    return _patched(dg, "patristic_distance_series", make)


FAULTS = {f.__name__: f for f in (frozen_step, half_reads, half_mapped,
                                  altered_alignment, altered_loglike,
                                  always_accept, zeroed_patristic)}
