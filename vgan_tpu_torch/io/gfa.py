# Copied from vgan_tpu/io/gfa.py; imports repointed to this package.
"""GFA 1.0 parser producing the packed graph arrays.

The reference loads graphs through bdsg::ODGI (`src/readPathHandleGraph.cpp`,
`src/readOG_Euka.h`); our DB compiler instead consumes the GFA text form
(as emitted by `vg view`, see `test/reconstructInputSeq/cmds:7`) and
packs it into flat numpy arrays (see vgan_tpu.graph.packed.PackedGraph).
"""
from __future__ import annotations

import gzip
from typing import Dict, List, Tuple


def parse_gfa(path: str):
    """Parse S/P/L lines. Returns (segments, paths, links).

    segments: dict node_id(int) -> sequence(str)
    paths: list of (name, [(node_id, is_reverse), ...])
    links: list of (from_id, from_rev, to_id, to_rev)
    """
    opener = gzip.open if path.endswith(".gz") else open
    segments: Dict[int, str] = {}
    paths: List[Tuple[str, List[Tuple[int, bool]]]] = []
    links: List[Tuple[int, bool, int, bool]] = []
    with opener(path, "rt") as f:
        for line in f:
            if not line or line[0] not in "SPLW":
                continue
            fields = line.rstrip("\n").split("\t")
            tag = fields[0]
            if tag == "S":
                segments[int(fields[1])] = fields[2].upper()
            elif tag == "P":
                name = fields[1]
                steps = []
                if fields[2] and fields[2] != "*":
                    for step in fields[2].split(","):
                        steps.append((int(step[:-1]), step[-1] == "-"))
                paths.append((name, steps))
            elif tag == "L":
                links.append(
                    (int(fields[1]), fields[2] == "-", int(fields[3]), fields[4] == "-")
                )
            elif tag == "W":  # walk lines (GFA 1.1) -> convert to path
                name = "#".join(fields[2:5])
                walk = fields[6]
                steps = []
                cur = ""
                rev = False
                for ch in walk:
                    if ch in "><":
                        if cur:
                            steps.append((int(cur), rev))
                        rev = ch == "<"
                        cur = ""
                    else:
                        cur += ch
                if cur:
                    steps.append((int(cur), rev))
                paths.append((name, steps))
    return segments, paths, links
