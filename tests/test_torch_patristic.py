"""soibean's patristic-distance series (vgan_tpu_torch/infer/patristic.py,
csrc/patristic.cu) against the held host function
(infer/diagnostics.patristic_distance_series), byte for byte: the plain
version on the cached tables and a numpy model of the kernel's sum order
on the CPU; the table cache; process_chain's device argument; and, marked
`cuda` (they skip where torch.cuda.is_available() is false), the kernel
and process_chain on the card. This file imports neither jax nor
vgan_tpu:

    python -m pytest --noconftest tests/test_torch_patristic.py -q
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.world import random_tree  # noqa: E402
from vgan_tpu_torch.infer import diagnostics as dg  # noqa: E402
from vgan_tpu_torch.infer import patristic as pt  # noqa: E402
from vgan_tpu_torch.infer.tree_mcmc import MCMCTrace  # noqa: E402
from vgan_tpu_torch.pipelines.soibean_runner import process_chain  # noqa
from vgan_tpu_torch.utils.newick import parse_newick  # noqa: E402
from vgan_tpu_torch.utils.profiling import PROFILER  # noqa: E402

# (leaves, tree seed): below numpy's 8-term block, one block with a
# remainder, the benchmark cell's tree (random_tree(128, 7)), and a row
# that numpy's pairwise sum halves twice
TREES = [(5, 1), (37, 2), (128, 7), (300, 3)]
# a chain source of the cell: iterations 75,001..500,000 after burn-in
CELL_STATES = 425_000


def _tree(leaves, seed):
    return parse_newick(random_tree(leaves, seed)[0])


def _states(tree, S, seed):
    """S recorded states: the root and every leaf first, then runs on one
    node as a chain records them; positions in [0, 1] with 0 and 1
    among them. nodes int32, pos f64, as a trace column holds them."""
    rng = np.random.default_rng(seed)
    leaves = np.nonzero(tree.n_children == 0)[0]
    head = np.concatenate([[tree.root], leaves])
    runs = rng.integers(0, tree.n_nodes, size=S // 50 + 1)
    nodes = np.concatenate([head, np.repeat(runs, 50)])[:S].astype(np.int32)
    pos = rng.random(S)
    pos[::7] = 0.0
    pos[3::7] = 1.0
    return nodes, pos


def _kernel_order_sum(t):
    """Row sums of t [S, n] in csrc/patristic.cu's order (numpy's
    pairwise_sum), each addition a numpy f64 addition."""
    def pairwise(j0, n):
        if n < 8:
            res = np.zeros(len(t))
            for i in range(n):
                res = res + t[:, j0 + i]
            return res
        if n <= 128:
            r = [t[:, j0 + k] for k in range(8)]
            i = 8
            while i < n - n % 8:
                r = [r[k] + t[:, j0 + i + k] for k in range(8)]
                i += 8
            res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5])
                                                     + (r[6] + r[7]))
            for i in range(i, n):
                res = res + t[:, j0 + i]
            return res
        n2 = n // 2
        n2 -= n2 % 8
        return pairwise(j0, n2) + pairwise(j0 + n2, n - n2)
    return pairwise(0, t.shape[1])


@pytest.mark.parametrize("leaves,seed", TREES)
def test_plain_on_cached_tables_equals_held_function(leaves, seed):
    tree = _tree(leaves, seed)
    nodes, pos = _states(tree, 3000, leaves)
    want = dg.patristic_distance_series(tree, nodes, pos)
    got = pt.patristic_distance_series(pt.patristic_tables(tree), nodes, pos,
                                       "cpu")
    assert got.dtype == np.float64
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("leaves,seed", TREES)
def test_kernel_sum_order_equals_held_function(leaves, seed):
    """The kernel's arithmetic, modelled term by term in numpy: each
    operation rounded alone, the leaves summed in pairwise order."""
    tree = _tree(leaves, seed)
    tables = pt.patristic_tables(tree)
    nodes, pos = _states(tree, 3000, leaves + 1)
    pob = tables.dist[nodes] * (1.0 - pos)
    ns = tables.dn[nodes] - pob[:, None]
    d = (ns + tables.dl[nodes]) - 1.0
    terms = np.where(ns >= 0.0, d * d, 0.0)
    got = np.sqrt(_kernel_order_sum(terms))
    want = dg.patristic_distance_series(tree, nodes, pos)
    assert got.tobytes() == want.tobytes()


def test_tables_built_once_per_tree_content():
    pt._TABLES.clear()
    with PROFILER.recording():
        PROFILER.clear()
        a = pt.patristic_tables(_tree(37, 2))
        # the same tree parsed again: another object, the same content
        assert pt.patristic_tables(_tree(37, 2)) is a
        assert PROFILER.counters["patristic.table_builds"] == 1
        other = _tree(37, 2)
        other.dist[3] += 0.01
        assert pt.patristic_tables(other) is not a
        assert PROFILER.counters["patristic.table_builds"] == 2
        PROFILER.clear()


def _chain_trace(tree, k, S, seed):
    rng = np.random.default_rng(seed)
    cols = [_states(tree, S, seed + s) for s in range(k)]
    theta = rng.dirichlet(np.ones(k), size=S)
    return MCMCTrace(node=np.stack([c[0] for c in cols], axis=1),
                     pos=np.stack([c[1] for c in cols], axis=1),
                     theta=theta, loglike=rng.normal(-900.0, 5.0, size=S))


def test_process_chain_on_cpu_device_equals_no_device():
    tree = _tree(37, 2)
    trace = _chain_trace(tree, 3, 2000, 11)
    want = process_chain(trace, tree, 3, "", 0, write_files=False)
    got = process_chain(trace, tree, 3, "", 0, write_files=False,
                        device=torch.device("cpu"))
    assert got.est_lines == want.est_lines
    assert got.branch_lines == want.branch_lines


def test_wrapper_raises_for_an_unsupported_device():
    tree = _tree(5, 1)
    nodes, pos = _states(tree, 20, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        pt.patristic_distance_series(pt.patristic_tables(tree), nodes, pos,
                                     "meta")


# ---------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("leaves,seed", TREES)
def test_kernel_equals_held_function(dev, leaves, seed):
    tree = _tree(leaves, seed)
    nodes, pos = _states(tree, 3000, leaves)
    pt.reset_launches()
    got = pt.patristic_distance_series(pt.patristic_tables(tree), nodes, pos,
                                       dev)
    assert pt.LAUNCHES["patristic_series"] == 1
    assert got.tobytes() == dg.patristic_distance_series(
        tree, nodes, pos).tobytes()


@pytest.mark.cuda
def test_kernel_equals_held_function_at_the_cells_shape(dev):
    """A chain source of the benchmark cell: 425,000 states of
    random_tree(128, 7), as strided columns of a [S, 3] trace."""
    tree = _tree(128, 7)
    cols = [_states(tree, CELL_STATES, s) for s in range(3)]
    node = np.stack([c[0] for c in cols], axis=1)
    pos = np.stack([c[1] for c in cols], axis=1)
    got = pt.patristic_distance_series(pt.patristic_tables(tree), node[:, 1],
                                       pos[:, 1], dev)
    assert got.tobytes() == dg.patristic_distance_series(
        tree, node[:, 1], pos[:, 1]).tobytes()


@pytest.mark.cuda
def test_process_chain_on_card_equals_cpu(dev):
    """A small k-sweep (k = 1..3, 2 chains) run on the card; each chain's
    printed estimates with the series on the card equal those of the
    held host function, one launch a chain source."""
    from vgan_tpu_torch.infer import tree_mcmc as tm

    tree = _tree(37, 2)
    rng = np.random.default_rng(5)
    R, N = 300, tree.n_nodes
    leaves = np.nonzero(tree.n_children == 0)[0]
    path_map = np.full((R, N), -40.0)
    path_map[: R // 2, leaves[0]] = -20.0
    path_map[R // 2:, leaves[-1]] = -22.0
    path_map += rng.uniform(-0.5, 0.5, size=(R, N))
    counts25 = rng.integers(0, 4, size=(R, N, 25))
    srcs = [np.array([[leaves[0]], [1]]),
            np.array([[leaves[0], leaves[-1]], [2, 7]]),
            np.array([[leaves[0], leaves[-1], 0], [3, 3, 5]])]
    freqs = dict(A=0.3, C=0.2, G=0.22, T=0.28, R=0.52, Y=0.48, M=1.0)
    traces = tm.run_tree_mcmc_ksweep(
        tree, path_map, counts25, srcs, freqs, con=0.05, max_iter=3000,
        burn=500, num_paths=N, init_logls=[-900.0, -880.0, -870.0],
        seeds_per_k=[[10, 11], [20, 21], [30, 31]], device=dev)
    for k, tr in enumerate(traces, start=1):
        for chain in range(2):
            trace = MCMCTrace(node=tr.node[chain], pos=tr.pos[chain],
                              theta=tr.theta[chain],
                              loglike=tr.loglike[chain])
            pt.reset_launches()
            got = process_chain(trace, tree, k, "", chain, write_files=False,
                                device=dev)
            assert pt.LAUNCHES["patristic_series"] == k
            want = process_chain(trace, tree, k, "", chain,
                                 write_files=False)
            assert got.est_lines == want.est_lines
            assert got.branch_lines == want.branch_lines
