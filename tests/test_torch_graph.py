"""The port's GFA loader (PackedGraph.from_gfa over its copy of io/gfa.py)
against the JAX package's, on a GFA written from a synthetic haplotype
graph and on an edited copy of it with reverse steps and links."""
import numpy as np
import pytest
import torch

import _torch_world as world
from vgan_tpu.graph import synth as jax_synth
from vgan_tpu.graph.packed import PackedGraph as JaxGraph
from vgan_tpu_torch.graph.packed import PackedGraph as PortGraph

torch.set_num_threads(1)


def _saved_fields(graph, path):
    """Every array PackedGraph.save writes, read back raw."""
    graph.save(str(path))
    with np.load(str(path), allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("reverse_steps", [False, True])
def test_from_gfa_equals_jax(tmp_path, reverse_steps):
    graph, _ = jax_synth.build_haplotype_graph(
        world.backbone(600, 1), n_haplotypes=4, n_variants=10, seed=1)
    gfa = tmp_path / "g.gfa"
    world.write_gfa(graph, gfa)
    if reverse_steps:
        # one path walked backwards and one link on reverse strands
        lines = gfa.read_text().splitlines()
        for i, line in enumerate(lines):
            if line.startswith("P\t"):
                f = line.split("\t")
                steps = f[2].split(",")[::-1]
                f[2] = ",".join(s[:-1] + ("-" if s[-1] == "+" else "+")
                                for s in steps)
                lines[i] = "\t".join(f)
                break
        lines.append("L\t3\t-\t2\t-\t0M")
        gfa.write_text("\n".join(lines) + "\n")
    got = _saved_fields(PortGraph.from_gfa(str(gfa)), tmp_path / "port.npz")
    want = _saved_fields(JaxGraph.from_gfa(str(gfa)), tmp_path / "jax.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["n_paths"]) == graph.n_paths
