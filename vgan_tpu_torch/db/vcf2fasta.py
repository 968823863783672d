# Copied from vgan_tpu/db/vcf2fasta.py.
"""vcf2fasta: apply a single-sample VCF to a reference chromosome.

Reimplements `share/vgan/hc_scripts/vcf2fasta.py` (the HaploCart
input-preparation helper) without the pysam dependency: plain or
gzip/BGZF VCF text parse, FASTA region fetch, homozygous-genotype
consensus splice, sample-ID FASTA header on stdout.

Preserved reference behaviors (all load-bearing for output parity):
* exactly one sample required; heterozygous or out-of-range genotypes
  abort with the reference's message.
* variants are applied IN FILE ORDER on the mutating string at their
  original VCF coordinates — after an indel, later variant positions
  are NOT shifted (the script splices `fasta_sequence[:pos] + alt +
  fasta_sequence[pos+len(ref):]` sequentially; mtDNA VCFs it targets
  are SNV-dominated so the drift rarely bites, but we reproduce it).
* the modify branch is skipped only for genotype == (0,): a diploid
  hom-ref (0,0) record IS applied with `alts[genotype[0]-1]` =
  alts[-1] (the script's genotype[0]-1 == -1 wraparound); haploid
  VCFs — its actual use case — never hit this.
* the REF column is validated against the FASTA (uppercased) before
  splicing; a mismatch aborts.
* one "Warning: Variant added..." stderr line per applied variant.
"""
from __future__ import annotations

import gzip
import sys
from typing import List, Optional, Tuple


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def _read_fasta_chrom(path: str, chrom: str) -> Optional[str]:
    """Fetch one chromosome (header's first token must equal chrom)."""
    seqs: List[str] = []
    take = False
    with _open_text(path) as f:
        for line in f:
            if line.startswith(">"):
                if take:
                    break
                take = line[1:].split()[0] == chrom
            elif take:
                seqs.append(line.strip())
    return "".join(seqs) if take or seqs else None


def _parse_gt(sample_field: str, fmt: str) -> Tuple[int, ...]:
    keys = fmt.split(":")
    vals = sample_field.split(":")
    try:
        gt_raw = vals[keys.index("GT")]
    except (ValueError, IndexError):
        return ()
    out = []
    for tok in gt_raw.replace("|", "/").split("/"):
        if tok == "." or tok == "":
            out.append(-1)
        else:
            out.append(int(tok))
    return tuple(out)


def add_variants_to_fasta(
    vcf_path: str, fasta_path: str, chrom: str, out=None, err=None
) -> int:
    out = out or sys.stdout
    err = err or sys.stderr

    samples: List[str] = []
    records = []
    with _open_text(vcf_path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                cols = line.rstrip("\n").split("\t")
                samples = cols[9:]
                continue
            if not line.strip():
                continue
            t = line.rstrip("\n").split("\t")
            if t[0] != chrom:
                continue
            records.append(t)

    if len(samples) != 1:
        err.write("Error: The VCF file contains more than one individual.\n")
        return 1
    individual_id = samples[0]

    if not records:
        err.write(
            "Error: There are no variants for this individual on this "
            "chromosome.\n"
        )
        return 1

    fasta_sequence = _read_fasta_chrom(fasta_path, chrom)
    if fasta_sequence is None:
        err.write(f"Error: chromosome {chrom} not found in {fasta_path}.\n")
        return 1
    original = fasta_sequence

    for t in records:
        pos = int(t[1]) - 1
        ref = t[3]
        alts = t[4].split(",")
        fmt = t[8] if len(t) > 8 else "GT"
        genotype = _parse_gt(t[9] if len(t) > 9 else "", fmt)
        if len(set(genotype)) != 1 or genotype[0] not in range(
            len(alts) + 1
        ):
            err.write(
                f"Error: Unexpected genotype {genotype} at position "
                f"{pos + 1}.\n"
            )
            return 1
        if genotype != (0,):
            # REF validates against the ORIGINAL fasta (the script
            # fetches from the file) while the splice hits the mutating
            # string — that split is the coordinate-drift quirk above
            ref_segment = original[pos : pos + len(ref)].upper()
            if ref_segment != ref:
                err.write(
                    f"Error: The reference in the VCF ({ref}) and the "
                    f"FASTA ({ref_segment}) at position {pos + 1} do "
                    "not match.\n"
                )
                return 1
            alt = alts[genotype[0] - 1]
            fasta_sequence = (
                fasta_sequence[:pos] + alt
                + fasta_sequence[pos + len(ref):]
            )
            err.write(
                f"Warning: Variant added at position {pos + 1}. "
                f"Reference {ref} replaced with {alt}.\n"
            )

    out.write(">" + individual_id + "\n")
    out.write(fasta_sequence + "\n")
    return 0
