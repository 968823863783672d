# The stream's definition frozen from vgan_tpu_torch/infer/tree_mcmc.py (draw_noise, _mix, NOISE_BLOCK, POST_BURN_HOPS).
"""A soibean chain row's noise, drawn again from the row's seed.

The sampler takes all its randomness as an input: iterations are cut
into blocks of 1,024, and a row's block comes from a torch generator on
the chain's device seeded from (the row's seed, the block, the walk's hop
bound) by splitmix64 rounds, which draws in turn a normal delta a source,
hops x 4 walk uniforms a source, a truncated-normal uniform a source and
an accept uniform, all float32, at the batch's widest k. After burn-in
the walk has at most 8 hops. Plain PyTorch; nothing of the program.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

BLOCK = 1024
POST_BURN_HOPS = 8
_MASK64 = (1 << 64) - 1


def mix(*xs) -> int:
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = (h ^ (int(x) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


class RowNoise:
    """Noise of one row at chosen iterations, block by block."""

    def __init__(self, seed: int, kmax: int, hops: int, device):
        self.seed, self.kmax, self.hops = int(seed), kmax, hops
        self.device = torch.device(device)
        self._blocks: Dict[int, Tuple[np.ndarray, ...]] = {}

    def _block(self, b: int):
        if b not in self._blocks:
            g = torch.Generator(device=self.device).manual_seed(
                mix(self.seed, b, self.hops))
            kw = dict(generator=g, dtype=torch.float32, device=self.device)
            k, n = self.kmax, BLOCK
            self._blocks[b] = tuple(x.cpu().numpy() for x in (
                torch.randn((n, k), **kw),
                torch.rand((n, k, self.hops, 4), **kw),
                torch.rand((n, k), **kw),
                torch.rand((n,), **kw)))
        return self._blocks[b]

    def at(self, it: int):
        """(delta [kmax], walk [kmax, hops, 4], trunc [kmax], acc) of
        iteration `it`."""
        b, j = divmod(it, BLOCK)
        return tuple(x[j] for x in self._block(b))
