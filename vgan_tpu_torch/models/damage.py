# Port of vgan_tpu/models/damage.py to torch (host part copied; tables and dinuc_gather in torch).
"""Ancient-DNA deamination (damage) model.

Reimplements `Damage::initDeamProbabilities` (`src/damage.cpp:41-323`)
as two compact [MAXLEN, 4, 4] substitution tables (5' and 3') plus an
on-the-fly combiner, instead of materializing the reference's
``subDeamDiNuc[L][l]`` ragged vector-of-vectors:

* profile files are 12-column TSVs (header ``A>C A>G ... T>G``,
  `src/miscfunc.h:84-136`); row i is the substitution rate at distance
  i from the fragment end; the last row is repeated out to
  MAXLENGTHFRAGMENT (`src/damage.cpp:91-93`).
* the per-(fragment length L, position l) matrix is
  ``combine(sub5p[l], sub3p[L-l-1])`` where ``combine`` picks, per
  original base b1, whichever profile row has the smaller diagonal
  (identity) entry — i.e. the *worse* damage (`src/damage.cpp:18-36`;
  ties go to the 5' row).
* fragment-length bounds 15..1000 (`src/damage.h:42-43`); indices are
  clamped into the table.

`dinuc_gather` evaluates the combine rule for arbitrary (L, l) index
tensors on the tables' device. torch indexing does not clamp (JAX's
does), so both indices are clamped explicitly before the gather.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np
import torch

MINLENGTHFRAGMENT = 15
MAXLENGTHFRAGMENT = 1000

# column order of .prof files: A>C A>G A>T C>A C>G C>T G>A G>C G>T T>A T>C T>G
_PAIRS = [
    (0, 1), (0, 2), (0, 3),
    (1, 0), (1, 2), (1, 3),
    (2, 0), (2, 1), (2, 3),
    (3, 0), (3, 1), (3, 2),
]


def read_prof(path: str) -> np.ndarray:
    """Parse a 12-column substitution-rate profile ->
    [n_rows, 4, 4] matrices with diagonal = 1 - sum(off-diagonal row),
    as `src/damage.cpp:66-88` builds them. Accepts 13-column files
    (trailing field dropped, `src/miscfunc.h:99`)."""
    opener = gzip.open if path.endswith(".gz") else open
    rows = []
    with opener(path, "rt") as f:
        header = f.readline()
        if not header:
            raise ValueError(f"empty profile {path}")
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) == 13:
                fields = fields[:12]
            if len(fields) != 12:
                raise ValueError(
                    f"profile line has {len(fields)} fields rather than 12"
                )
            rows.append([float(x) for x in fields])
    rates = np.array(rows, dtype=np.float64)  # [n, 12]
    n = len(rows)
    mats = np.zeros((n, 4, 4), dtype=np.float64)
    for k, (b1, b2) in enumerate(_PAIRS):
        mats[:, b1, b2] = rates[:, k]
    diag = 1.0 - mats.sum(axis=2)
    if (diag < 0).any():
        raise ValueError("deamination profile identity probability < 0")
    for b in range(4):
        mats[:, b, b] = diag[:, b]
    return mats


def _extend(mats: np.ndarray, maxlen: int = MAXLENGTHFRAGMENT) -> np.ndarray:
    """Repeat the last row out to maxlen positions."""
    if len(mats) >= maxlen:
        return mats[:maxlen]
    pad = np.repeat(mats[-1:], maxlen - len(mats), axis=0)
    return np.concatenate([mats, pad], axis=0)


def _identity_profile(maxlen: int = MAXLENGTHFRAGMENT) -> np.ndarray:
    out = np.zeros((maxlen, 4, 4), dtype=np.float64)
    out[:, np.arange(4), np.arange(4)] = 1.0
    return out


@dataclass
class DamageModel:
    """sub5p/sub3p: [MAXLEN, 4, 4] post-damage substitution tables."""

    sub5p: np.ndarray
    sub3p: np.ndarray

    @classmethod
    def from_profiles(cls, deam5p: str | None, deam3p: str | None) -> "DamageModel":
        s5 = _extend(read_prof(deam5p)) if deam5p else _identity_profile()
        s3 = _extend(read_prof(deam3p)) if deam3p else _identity_profile()
        return cls(sub5p=s5, sub3p=s3)

    @classmethod
    def none(cls) -> "DamageModel":
        return cls(sub5p=_identity_profile(), sub3p=_identity_profile())

    # ---------------------------------------------------------------- host
    def dinuc(self, L: int, l: int) -> np.ndarray:
        """subDeamDiNuc[L][l]: 4x4 matrix for fragment length L,
        position l (from the 5' end). Indices clamped into the table."""
        L = int(np.clip(L, 1, MAXLENGTHFRAGMENT))
        l5 = int(np.clip(l, 0, MAXLENGTHFRAGMENT - 1))
        l3 = int(np.clip(L - l - 1, 0, MAXLENGTHFRAGMENT - 1))
        f5 = self.sub5p[l5]
        f3 = self.sub3p[l3]
        out = np.empty((4, 4), dtype=np.float64)
        for b in range(4):
            # `combineDeamRates` (`src/damage.cpp:18-36`): lower identity wins
            out[b] = f5[b] if f5[b, b] <= f3[b, b] else f3[b]
        return out

    # ---------------------------------------------------------------- device
    def tables(self, device, dtype=torch.float64):
        return (torch.as_tensor(self.sub5p, dtype=dtype, device=device),
                torch.as_tensor(self.sub3p, dtype=dtype, device=device))


def dinuc_gather(sub5p: torch.Tensor, sub3p: torch.Tensor, L, l):
    """Vectorized subDeamDiNuc[L][l] lookup.

    sub5p/sub3p: [MAXLEN, 4, 4] tensors; L, l: integer tensors of
    broadcastable shapes on the tables' device. Returns [..., 4, 4]."""
    maxlen = sub5p.shape[0]
    l5 = torch.clamp(l, 0, maxlen - 1).long()
    l3 = torch.clamp(L - l - 1, 0, maxlen - 1).long()
    f5 = sub5p[l5]  # [..., 4, 4]
    f3 = sub3p[l3]
    d5 = torch.diagonal(f5, dim1=-2, dim2=-1)  # [..., 4]
    d3 = torch.diagonal(f3, dim1=-2, dim2=-1)
    use5 = (d5 <= d3)[..., None]  # per original-base row choice
    return torch.where(use5, f5, f3)
