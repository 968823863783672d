"""Reference-free world shared by the port's parity tests: a seeded
random ACGT backbone turned into a HaploCart-shaped haplotype graph
(graph/synth.build_haplotype_graph), its graph.npz DB directory, and
reads sampled from one haplotype written as FASTQ.

Numpy, the given synth module and the port's bench module (which
imports no JAX), so the no-jax test can build the same world through
the port's copy of graph/synth.py."""
import os

import numpy as np

# the FASTQ writer and the random tree are the port's bench's (no JAX)
from vgan_tpu_torch.bench import random_tree, write_fastq  # noqa: F401

N_BP, N_HAPS, N_VARIANTS, N_READS, HAP, SEED = 2000, 16, 40, 300, 5, 3


def backbone(n_bp: int, seed: int) -> str:
    codes = np.random.default_rng(seed).integers(0, 4, size=n_bp)
    return np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes().decode()


def build(synth, out_dir, n_bp=N_BP, n_haps=N_HAPS, n_variants=N_VARIANTS,
          n_reads=N_READS, hap=HAP, seed=SEED):
    """Returns (graph, db_dir, fastq_path, reads)."""
    graph, _ = synth.build_haplotype_graph(
        backbone(n_bp, seed), n_haplotypes=n_haps, n_variants=n_variants,
        seed=seed,
    )
    db_dir = os.path.join(str(out_dir), "db")
    os.makedirs(db_dir, exist_ok=True)
    graph.save(os.path.join(db_dir, "graph.npz"))
    reads = synth.sample_reads(graph, hap, n_reads, seed=0)
    fq = os.path.join(str(out_dir), "reads.fq")
    write_fastq(fq, reads)
    return graph, db_dir, fq, reads


# ------------------------------------------------------------ euka worlds
# C>T at the 5' end and G>A at the 3' end, by distance from the end
# (a synthetic aDNA damage profile); every other substitution 0
DEAM_RATES = (0.30, 0.15, 0.08, 0.04, 0.02)
PROF_HEADER = "A>C\tA>G\tA>T\tC>A\tC>G\tC>T\tG>A\tG>C\tG>T\tT>A\tT>C\tT>G\n"


def merge_graphs(packed_cls, graphs):
    """Concatenate disjoint graphs into one (disjoint node-id ranges),
    like euka_db's per-taxon node regions; tests/test_euka_e2e.py's
    _merge_graphs, for either package's PackedGraph. Returns (graph,
    [(first_id, last_id)] per graph)."""
    pools, offs, paths_n, paths_r, names = [], [], [], [], []
    edges_f, edges_fr, edges_t, edges_tr = [], [], [], []
    node_base = 0
    pool_base = 0
    ranges = []
    for g in graphs:
        pools.append(g.node_seq_pool)
        offs.append(g.node_off[1:] + pool_base)
        for j in range(g.n_paths):
            names.append(g.path_names[j])
            paths_n.append(g.path_steps_node[j] + node_base)
            paths_r.append(g.path_steps_rev[j])
        edges_f.append(g.edge_from + node_base)
        edges_fr.append(g.edge_from_rev)
        edges_t.append(g.edge_to + node_base)
        edges_tr.append(g.edge_to_rev)
        ranges.append((node_base + 1, node_base + g.n_nodes))  # 1-based ids
        node_base += g.n_nodes
        pool_base += len(g.node_seq_pool)
    node_off = np.concatenate([np.zeros(1, np.int64)] + offs).astype(np.int64)
    support = np.zeros((node_base, len(names)), dtype=bool)
    for j, sn in enumerate(paths_n):
        support[sn, j] = True
    return (
        packed_cls(
            min_id=1,
            node_seq_pool=np.concatenate(pools),
            node_off=node_off,
            edge_from=np.concatenate(edges_f),
            edge_from_rev=np.concatenate(edges_fr),
            edge_to=np.concatenate(edges_t),
            edge_to_rev=np.concatenate(edges_tr),
            path_names=names,
            path_steps_node=paths_n,
            path_steps_rev=paths_r,
            path_support=support,
        ),
        ranges,
    )


def build_euka_graph(synth, packed_cls, n_taxa=3, n_bp=3000, n_haps=2,
                     n_variants=8, seed=5):
    """Taxon t is a haplotype graph over its own random backbone (drawn
    in turn from one generator seeded with `seed`; graph seed 20 + t),
    paths tax{t}_h0.., merged over disjoint node ranges (the 3-taxon
    world of tests/test_euka_e2e.py with the defaults)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for t in range(n_taxa):
        codes = rng.integers(0, 4, size=n_bp)
        seq = np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes().decode()
        g, _ = synth.build_haplotype_graph(
            seq, n_haplotypes=n_haps, n_variants=n_variants, seed=20 + t,
            hap_names=[f"tax{t}_h{j}" for j in range(n_haps)],
        )
        graphs.append(g)
    return merge_graphs(packed_cls, graphs)


def euka_bins(ranges, n_bins=8, whole_bin=False):
    """Per taxon: n_bins equal node-range bins at entropy 1.5, plus (with
    whole_bin) a trailing whole-range bin at 0.5 that detection ignores
    (bench.py's real-DB layout)."""
    chunks = []
    for lo, hi in ranges:
        bounds = np.linspace(lo, hi, n_bins + 1).astype(int)
        row = [(int(bounds[i]), int(bounds[i + 1]), 1.5) for i in range(n_bins)]
        if whole_bin:
            row.append((lo, hi, 0.5))
        chunks.append(row)
    return chunks


def write_euka_db(out_dir, graph, ranges, n_haps, dists, chunks,
                  prefix="euka_db"):
    """<out_dir>/<prefix>.{npz,clade,bins} plus the deam5p/deam3p
    profiles; returns (euka_dir, deam5p, deam3p)."""
    d = str(out_dir)
    os.makedirs(d, exist_ok=True)
    graph.save(os.path.join(d, prefix + ".npz"))
    with open(os.path.join(d, prefix + ".clade"), "w") as f:
        for t, (lo, hi) in enumerate(ranges):
            f.write(f"{t} Taxon{t} {dists[t]} {n_haps} {lo} {hi}\n")
    with open(os.path.join(d, prefix + ".bins"), "w") as f:
        for t, row in enumerate(chunks):
            f.write(f"Taxon{t} " + " ".join(
                f"{lo}.0 {hi}.0 {ent}" for lo, hi, ent in row) + "\n")
    return (d,) + write_damage_profiles(d)


def write_damage_profiles(out_dir):
    """<out_dir>/deam5p.prof (C>T) and deam3p.prof (G>A) at DEAM_RATES;
    returns their paths."""
    paths = []
    for name, col in (("deam5p.prof", 5), ("deam3p.prof", 6)):
        path = os.path.join(str(out_dir), name)
        with open(path, "w") as f:
            f.write(PROF_HEADER)
            for v in DEAM_RATES:
                row = ["0"] * 12
                row[col] = repr(v)
                f.write("\t".join(row) + "\n")
        paths.append(path)
    return paths[0], paths[1]


def write_mixture_fastq(synth, graph, path, mix, n_haps, read_len=80,
                        seed=40):
    """Reads of haplotype 0 of each (taxon, n_reads) in `mix`, named
    t<taxon>_r<i>, as FASTQ."""
    reads = []
    for i, (t, n) in enumerate(mix):
        for r in synth.sample_reads(graph, t * n_haps, n, read_len=read_len,
                                    seed=seed + i):
            r.name = f"t{t}_{r.name}"
            reads.append(r)
    write_fastq(path, reads)
    return reads


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def write_pairs(graph, fq1, fq2, interleaved, path_idx, n_pairs,
                frag_len=200, read_len=64, seed=0):
    """Mate pairs of a fragment of one path (read 1 forward, read 2 the
    reverse complement of the fragment's end; tests/test_mapper.py's
    _make_pairs) as two FASTQs and one interleaved FASTQ."""
    rng = np.random.default_rng(seed)
    recs1, recs2 = [], []
    for pi in ([path_idx] if isinstance(path_idx, int) else path_idx):
        seq = graph.path_seq(pi)
        for i in range(n_pairs):
            start = int(rng.integers(0, len(seq) - frag_len))
            frag = seq[start : start + frag_len]
            q = "".join(chr(33 + int(x))
                        for x in rng.integers(25, 40, size=read_len))
            recs1.append((f"p{pi}_{i}/1", frag[:read_len], q))
            recs2.append((f"p{pi}_{i}/2", _revcomp(frag[-read_len:]), q))
    for path, recs in ((fq1, recs1), (fq2, recs2),
                       (interleaved, [x for ab in zip(recs1, recs2)
                                      for x in ab])):
        with open(path, "w") as f:
            for name, s, q in recs:
                f.write(f"@{name}\n{s}\n+\n{q}\n")


def write_gfa(graph, path):
    """S/L/P lines of a PackedGraph (node ids min_id + index)."""
    m = graph.min_id
    with open(path, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for i in range(graph.n_nodes):
            codes = graph.node_seq_pool[graph.node_off[i]:graph.node_off[i + 1]]
            f.write(f"S\t{i + m}\t"
                    f"{np.frombuffer(b'ACGTN-SN', np.uint8)[codes].tobytes().decode()}\n")
        for a, ar, b, br in zip(graph.edge_from, graph.edge_from_rev,
                                graph.edge_to, graph.edge_to_rev):
            f.write(f"L\t{a + m}\t{'-' if ar else '+'}\t{b + m}\t"
                    f"{'-' if br else '+'}\t0M\n")
        for name, sn, sr in zip(graph.path_names, graph.path_steps_node,
                                graph.path_steps_rev):
            steps = ",".join(f"{n + m}{'-' if r else '+'}"
                             for n, r in zip(sn, sr))
            f.write(f"P\t{name}\t{steps}\t*\n")


# --------------------------------------------------------- soibean worlds
def build_tree_graph(synth, tree_world, n_bp, sites_per_unit, node_len=8,
                     seed=0):
    """One path per tree node over a seeded random backbone, with
    phylogenetic variants: each branch brings max(1, round(length *
    sites_per_unit)) new single-base variants on distinct backbone nodes
    (graph/synth.py's bubbles), and a node's path carries every variant
    on its way from the root. Returns (graph, private) with private the
    variant count of each node's own branch."""
    _nwk, children, length, root = tree_world
    rng = np.random.default_rng(seed)
    ref = backbone(n_bp, seed)
    n_backbone = (n_bp + node_len - 1) // node_len
    segments = {i + 1: ref[i * node_len:(i + 1) * node_len]
                for i in range(n_backbone)}
    pool = list(rng.permutation(np.arange(2, n_backbone)))
    alt_of, carried, private = {}, {root: set()}, {root: 0}
    links = [(i, False, i + 1, False) for i in range(1, n_backbone)]
    order = [root]
    for n in order:  # breadth first: parents before children
        for c in children.get(n, []):
            order.append(c)
            own = set()
            for _ in range(max(1, round(length[c] * sites_per_unit))):
                if not pool:
                    break
                nid = int(pool.pop())
                seq = segments[nid]
                off = int(rng.integers(0, len(seq)))
                alt = "ACGT"[("ACGT".find(seq[off]) + 1
                              + int(rng.integers(0, 3))) % 4]
                alt_id = n_backbone + 1 + len(alt_of)
                segments[alt_id] = seq[:off] + alt + seq[off + 1:]
                alt_of[nid] = alt_id
                links += [(nid - 1, False, alt_id, False),
                          (alt_id, False, nid + 1, False)]
                own.add(nid)
            carried[c] = carried[n] | own
            private[c] = len(own)
    paths = [(n, [(alt_of[i] if i in carried[n] else i, False)
                  for i in range(1, n_backbone + 1)]) for n in order]
    return synth._graph_from_parts(segments, paths, links), private


def write_soibean_db(out_dir, prefix, graph, newick, base_freqs):
    """<out_dir>/<prefix>.npz, soibean_db.baseFreq and
    tree_dir/<prefix>.new.dnd (the layout `vgan soibean --soibean_dir`
    reads). Returns out_dir."""
    d = str(out_dir)
    os.makedirs(os.path.join(d, "tree_dir"), exist_ok=True)
    graph.save(os.path.join(d, prefix + ".npz"))
    with open(os.path.join(d, "soibean_db.baseFreq"), "w") as f:
        f.write(f"{prefix} " + " ".join(f"{x:.6f}" for x in base_freqs)
                + "\n")
    with open(os.path.join(d, "tree_dir", prefix + ".new.dnd"), "w") as f:
        f.write(newick + "\n")
    return d


def write_source_fastq(synth, graph, path, mix, read_len=64, seed=60):
    """Reads of each (path name, n_reads) in `mix`, named <name>_r<i>,
    as FASTQ; returns them."""
    reads = []
    for i, (name, n) in enumerate(mix):
        for r in synth.sample_reads(graph, graph.path_names.index(name), n,
                                    read_len=read_len, seed=seed + i):
            r.name = f"{name}_{r.name}"
            reads.append(r)
    write_fastq(path, reads)
    return reads


# ----------------------------------------------------- keelime overlap pairs
KEELIME_ALPHABET = "ACGTRYNS-acgtry"  # pipelines/keelime.py:_ALPHABET


def _random_pairs(rng, alphabet, n, lo, hi):
    alpha = np.array(list(alphabet))
    return [("".join(rng.choice(alpha, int(rng.integers(lo, hi)))),
             "".join(rng.choice(alpha, int(rng.integers(lo, hi)))))
            for _ in range(n)]


def overlap_adversarial_pairs():
    """keelime overlap pairs: tests/test_keelime.py:441-465's sets,
    widened to the full 15-character alphabet and to bytes outside it,
    plus planted suffix/prefix overlaps."""
    rng = np.random.default_rng(13)
    full = KEELIME_ALPHABET
    pairs = _random_pairs(rng, "ACGTRYN-", 60, 5, 50)
    pairs += _random_pairs(rng, full, 80, 1, 60)
    pairs += _random_pairs(rng, full + "xZ#*", 40, 1, 60)
    for _ in range(40):
        core = "".join(rng.choice(np.array(list(full)), 20))
        pairs.append(("".join(rng.choice(np.array(list(full)), 10)) + core,
                      core + "".join(rng.choice(np.array(list(full)), 10))))
    return pairs


# the full-length block's best start scores 21.0, and a's suffix equals
# b's first 9 bases (27.0): at min_score 21.5 the scan falls through to the
# tail, which wins with (9, 27.0)
NEAR_MISS = ("GTGCGTGCAGTCACGTACGGT", "ACGTACGGTCATG")


def overlap_trap_pairs():
    """keelime overlap pairs at the scan's edge cases: case rules
    (lowercase acgtry against uppercase), -/N/S, bytes outside the
    alphabet (score 0), la < min_olen, lb > la (no full-length start),
    lb == 0, la == 0, a full-length max just under min_score
    (NEAR_MISS), and equal strings."""
    core = "ACGTACGGTCAT"
    return [
        ("acgtry" * 4, "ACGTRY" * 4), ("ACGTRY" * 4, "acgtry" * 4),
        ("gattaca" * 3, "GATTACA" * 3), ("ctga" * 6, "TCAG" * 6),
        ("--NNSS" * 4, "-NS-NS" * 4), ("ACGT" * 6, "NNNN" * 6),
        ("xyz!" * 8, "ACGT" * 8), ("ACGT" * 8, "qwer" * 8),
        ("\x00\xff\x7f" * 6, "\x00\xff\x7f" * 6),
        ("ACG", "ACGTACGT"), ("AC", "A"),
        ("ACGTTGCA", "ACGTTGCAACGTTGCA"), ("ACGTACGT", "GTACGTACGTTT"),
        ("ACGTACGT", ""), ("", "ACGT"), ("", ""),
        NEAR_MISS, ("TT" + core, core), (core + core, core),
        (core, core), ("GATTACA" * 5, "GATTACA" * 5),
    ]


def overlap_scores2(a, b, lut, t2):
    """The doubled overlap score of every start s of b along a (olen =
    min(lb, la - s)), by brute force: lut and t2 are
    keelime_device.code_tables()."""
    ca = lut[np.frombuffer(a.encode("latin-1"), np.uint8)]
    cb = lut[np.frombuffer(b.encode("latin-1"), np.uint8)]
    out = np.zeros(len(a), dtype=np.int64)
    for s in range(len(a)):
        n = min(len(b), len(a) - s)
        out[s] = t2[ca[s:s + n], cb[:n]].sum()
    return out


def long_overlap_cases(lut, t2):
    """{name: (pairs, min_olen, min_score)}: overlap pairs whose a is
    longer than L_WARP = 256 (overlap_best_kernel's class), at the edges
    of its cluster decomposition (position chunks a CTA, rounds of
    starts, the first qualifying start of a round): a of 257 bp, b longer
    than a, a tail winner in the second round of 128 starts (and at the
    last and the first start of a round), two qualifiers in one round
    whose scores come from a late and from an early position chunk (in
    both orders), a full block that misses min_score by 0.5 beside one
    that makes it, no winner, a shorter than min_olen, bytes outside the
    alphabet, and 16,569-bp pairs. lut and t2 are
    keelime_device.code_tables(); every planted property is asserted on
    brute-force scores."""
    rng = np.random.default_rng(41)
    acgt = np.array(list("ACGT"))

    def rand(n, alpha=acgt):
        return "".join(rng.choice(alpha, n))

    def starts(a, b):
        return overlap_scores2(a, b, lut, t2)

    cases = {}
    a = rand(257)
    cases["a257"] = ([(a, a), (a, a[40:] + rand(100)), (a, rand(257)),
                      (a, a[:200]), (a, rand(300))], 20, 30.0)
    a = rand(400)
    cases["lb_gt_la"] = ([(a, a[100:] + rand(600)), (a, rand(1000)),
                          (a, a + rand(5))], 20, 30.0)
    a = rand(1200)
    pairs = [(a, a[s:] + rand(s)) for s in (200, 128, 129)]
    for (x, y), s in zip(pairs, (200, 128, 129)):  # winner s, tail from 1
        sc = starts(x, y)
        assert sc[s] == 6 * (1200 - s) and (sc[1:s] < 4000).all()
    cases["tail_round2"] = (pairs, 50, 2000.0)
    # la = lb = 2000, the tail from s = 1: start s1 matches b over late
    # positions only, start s2 over early ones; both qualify, s1 first
    pairs = []
    for s1, s2 in ((10, 20), (30, 37)):
        a = rand(2000)
        b = list(rand(2000))
        late, early = (s1, s2) if s1 == 10 else (s2, s1)
        for j in range(1500, 2000 - late):
            b[j] = a[late + j]
        for j in range(0, 500):
            b[j] = a[early + j]
        b = "".join(b)
        sc = starts(a, b)
        pairs.append((a, b, sc))
    floor = min(min(sc[s1], sc[s2]) for (_, _, sc), (s1, s2)
                in zip(pairs, ((10, 20), (30, 37))))
    for (_, _, sc), (s1, s2) in zip(pairs, ((10, 20), (30, 37))):
        assert (sc[:s1] < floor).all() and min(sc[s1], sc[s2]) >= floor
    cases["early_late_chunks"] = ([(a, b) for a, b, _ in pairs], 100,
                                  floor / 2)
    a = rand(600)
    miss, hit = (a, a[150:550]), (a, a[150:551])
    assert starts(*miss)[:201].max() == 2 * 1200
    assert starts(*hit)[:200].max() == 2 * 1203
    cases["full_near_miss"] = ([miss, hit], 250, 1200.5)
    pairs = [(rand(700), rand(650)), (rand(900), rand(300)),
             (rand(500), rand(1200))]
    for x, y in pairs:
        assert starts(x, y)[:len(x) - 20 + 1].max() < 2 * 10.0
    cases["no_winner"] = (pairs, 20, 10.0)
    cases["la_lt_min_olen"] = ([(rand(300), rand(300)), (rand(280),
                                                       rand(1000))], 301,
                               1.0)
    # ACGT with one byte in five from the whole alphabet and outside it
    # (Python lists: numpy's str arrays drop "\x00")
    alpha = KEELIME_ALPHABET + "xZ\x00\xff"

    def mixed(n):
        x = list(rand(n))
        for k in np.flatnonzero(rng.random(n) < 0.2):
            x[k] = alpha[int(rng.integers(len(alpha)))]
        return "".join(x)

    a = mixed(900)
    pairs = [(a, a[300:] + mixed(200)), (a, mixed(700)), (mixed(400), a)]
    sc = starts(*pairs[0])
    assert (sc[:300] < sc[300]).all()
    cases["outside_alphabet"] = (pairs, 10, float(sc[300]) / 2)
    seq = rand(16569)
    cases["mitogenome"] = ([(seq, seq), (seq[:16000], seq[150:]),
                            (seq[:16400], seq[120:])], 40, 60.0)
    return cases


def hc_edge_arrays(rng, n_nodes, n_pang, M0=700, S=8):
    """A HaploCart mapping batch as pack_batch's arrays, with every edge
    the scorer must clamp or skip: empty rows (take = 0), codes >= 4 (N
    and 5..254) in g and r, q and mq past 99, pang past the tables'
    n_pang entries and below 0, node ids below 0 and at or past
    n_nodes."""
    take = rng.integers(0, S + 1, size=M0).astype(np.int32)
    v = np.arange(S)[None, :] < take[:, None]
    g = rng.integers(0, 4, size=(M0, S))
    odd = rng.random((M0, S))
    g = np.where(odd < 0.03, 4, np.where(odd < 0.05,
                                         rng.integers(5, 255, (M0, S)), g))
    r = np.where(rng.random((M0, S)) < 0.9, g, rng.integers(0, 256, (M0, S)))
    node = rng.integers(0, n_nodes, size=M0)
    node[rng.random(M0) < 0.02] = n_nodes + 3
    node[rng.random(M0) < 0.02] = -1
    pang = rng.integers(1, n_pang, size=M0)
    pang[rng.random(M0) < 0.03] = n_pang + 7
    neg = rng.random(M0) < 0.03  # -1 reads the last entry; below -n_pang, 0
    pang[neg] = -rng.integers(1, 2 * n_pang, size=int(neg.sum()))
    return dict(
        g=np.where(v, g, 255).astype(np.uint8),
        r=np.where(v, r, 255).astype(np.uint8),
        q=np.where(v, rng.integers(0, 256, size=(M0, S)), 0).astype(np.uint8),
        mq=rng.integers(0, 256, size=M0).astype(np.uint8),
        use_bep=(rng.random(M0) < 0.2).astype(np.uint8),
        pang=pang.astype(np.int32), node=node.astype(np.int32),
        take=take, b=-rng.random(M0) * 300.0, S=S,
    )


def hc_padded_columns(a, M):
    """pack_batch's arrays padded to M rows as pack_batch pads them
    (g = r = 255, everything else 0), with valid [M, S] from take: the
    columns of an HcBatch holding the same rows as the packed buffer."""
    M0, S = len(a["b"]), a["S"]

    def pad(x, fill=0):
        out = np.full((M,) + x.shape[1:], fill, x.dtype)
        out[:M0] = x
        return out

    take = pad(a["take"])
    return dict(
        g=pad(a["g"], 255).astype(np.int32),
        r=pad(a["r"], 255).astype(np.int32),
        q=pad(a["q"]).astype(np.int32), pang=pad(a["pang"]),
        mq=pad(a["mq"]).astype(np.int32), b=pad(a["b"]), node=pad(a["node"]),
        valid=np.arange(S)[None, :] < take[:, None],
        use_bep=pad(a["use_bep"]) > 0,
    )


# ------------------------------------------------------------ euka's scorer
EUKA_MAXLEN = 1000  # damage-table rows (models/damage.py MAXLENGTHFRAGMENT)
EUKA_CLASSES = ("N", "gap", "rare", "softclip", "ACGT")
_CLASS_CODE = {"N": 4, "gap": 5, "softclip": 6, "rare": 7}
# codes of a lower precedence than each class (N, gap, rare, softclip)
_LOWER = {"N": [0, 1, 2, 3, 5, 6, 7], "gap": [0, 1, 2, 3, 6, 7],
          "rare": [0, 1, 2, 3, 6], "softclip": [0, 1, 2, 3]}
I32_MIN, I32_MAX = -2**31, 2**31 - 1


def euka_damage_tables(rng, maxlen=EUKA_MAXLEN):
    """A random 5' / 3' damage-table pair, [maxlen, 4, 4] f64 each: small
    substitution rates off the diagonal, 1 - their row sum on it."""
    idx = np.arange(4)
    out = []
    for _ in range(2):
        t = rng.random((maxlen, 4, 4)) * 0.08
        t[:, idx, idx] = 0.0
        t[:, idx, idx] = 1.0 - t.sum(-1)
        out.append(t)
    return out


def _euka_rows(rng, B, L, code_hi=8, valid_p=0.85):
    """Random [B, L] scorer arrays: codes 0..code_hi - 1 (r equal to g
    at 70 %), q 0..99, n_pos inside the read, L_read L..2L, pair_dist in
    [0, 0.2), columns valid at valid_p."""
    g = rng.integers(0, code_hi, size=(B, L))
    r = np.where(rng.random((B, L)) < 0.7, g,
                 rng.integers(0, code_hi, size=(B, L)))
    L_read = rng.integers(max(L, 1), 2 * max(L, 1) + 1, size=B)
    n_pos = rng.integers(0, L_read[:, None], size=(B, L))
    return dict(g=g, r=r, q=rng.integers(0, 100, size=(B, L)), n_pos=n_pos,
                L_read=L_read, pair_dist=rng.random(B) * 0.2,
                valid=rng.random((B, L)) < valid_p)


def _euka_case(d, tables):
    arrays = tuple(np.ascontiguousarray(d[k]).astype(t) for k, t in (
        ("g", np.int32), ("r", np.int32), ("q", np.int32),
        ("n_pos", np.int32), ("L_read", np.int32),
        ("pair_dist", np.float64), ("valid", bool)))
    return arrays, tuple(np.ascontiguousarray(t, np.float64) for t in tables)


def euka_score_cases(qtab, bfreq, ttr, seed=0):
    """Inputs of euka's per-base scorer (score_batch) that its kernel and
    plain version must agree on, name -> ((g, r, q, n_pos, L_read,
    pair_dist, valid), (sub5p, sub3p, qtab, bfreq, ttr)), numpy arrays
    of the scorer's dtypes:

    * class_<name>: every column of one class (N, gap, rare, softclip,
      ACGT; ACGT with codes past 7 and below 0 in a few columns);
    * soft_runs: softclip runs that cross 32-column tiles, valid or not;
    * no_valid: rows with no valid column beside rows with some;
    * odd_L: L = 77, not a multiple of 32, every code;
    * out_of_tables: q, n_pos and L_read outside their tables on both
      sides, int32's extremes among them (l3 wraps);
    * negative_codes: g = N with r in {-1, -9, 9} (a negative code counts
      from the end of bfreq, then clamps), and negative codes in ACGT
      columns;
    * nan_inf_tables: NaN, +-inf, negative and zero entries in both
      damage tables, qtab entries 0 and 1, pair_dist 0 and 1;
    * mixed: every code, 96 rows of 48 columns."""
    rng = np.random.default_rng(seed)
    consts = (qtab, bfreq, ttr)
    cases = {}
    for name in EUKA_CLASSES:
        d = _euka_rows(rng, 16, 40, code_hi=4)
        if name == "ACGT":
            odd = rng.random(d["g"].shape) < 0.1
            d["g"] = np.where(odd, rng.choice([-3, 8, 12, 255], odd.shape),
                              d["g"])
        else:
            # the class's code on one side or both; the other side any
            # code of lower precedence
            c = _CLASS_CODE[name]
            side = rng.integers(0, 3, size=d["g"].shape)
            other = rng.choice(_LOWER[name], size=d["g"].shape)
            d["g"] = np.where(side == 1, other, c)
            d["r"] = np.where(side == 2, other, c)
        cases[f"class_{name}"] = _euka_case(
            d, euka_damage_tables(rng) + list(consts))
    d = _euka_rows(rng, 24, 100)
    d["r"][::2, 20:75] = 6
    d["g"][1::4, 30:40] = 6
    d["g"][1::4, 62:70] = 6
    d["valid"][::3, 25:45] = False
    cases["soft_runs"] = _euka_case(d, euka_damage_tables(rng) + list(consts))
    d = _euka_rows(rng, 9, 33)
    d["valid"][[0, 4, 8]] = False
    cases["no_valid"] = _euka_case(d, euka_damage_tables(rng) + list(consts))
    d = _euka_rows(rng, 20, 77)
    cases["odd_L"] = _euka_case(d, euka_damage_tables(rng) + list(consts))
    d = _euka_rows(rng, 32, 40, code_hi=4)
    B, L = d["g"].shape
    d["q"] = rng.integers(-300, 400, size=(B, L))
    d["n_pos"] = rng.integers(-3000, 4000, size=(B, L))
    d["L_read"] = rng.integers(-1500, 2500, size=B)
    d["q"][0, :4] = [I32_MIN, I32_MAX, -1, 100]
    d["n_pos"][1, :6] = [I32_MIN, I32_MAX, -1, 999, 1000, I32_MIN + 1]
    d["L_read"][1:5] = [I32_MIN, I32_MAX, 0, -1]
    d["n_pos"][2:5, :8] = I32_MIN
    cases["out_of_tables"] = _euka_case(
        d, euka_damage_tables(rng) + list(consts))
    d = _euka_rows(rng, 6, 40, code_hi=4)
    d["g"][:3] = 4
    d["r"][:3] = np.resize([-1, -9, 9], (3, 40))
    d["r"][3:] = np.where(rng.random((3, 40)) < 0.3, rng.choice(
        [-1, -5, -9, -100], (3, 40)), d["r"][3:])
    d["valid"][:] = True
    cases["negative_codes"] = _euka_case(
        d, euka_damage_tables(rng) + list(consts))
    # row i < 20 reads 5' table rows 2i and 2i + 1 in a quarter of its
    # columns, some of them poisoned; rows 10..19 the edge qualities too;
    # rows 20..39 only clean table rows and qualities
    d = _euka_rows(rng, 40, 64, code_hi=4)
    s5, s3 = euka_damage_tables(rng)
    for t in (s5, s3):
        for v in (np.nan, np.inf, -np.inf, -0.5, 0.0):
            rows = rng.integers(0, 40, size=3)
            t[rows, rng.integers(0, 4, 3), rng.integers(0, 4, 3)] = v
    d["n_pos"] = rng.integers(100, 200, size=(40, 64))
    d["L_read"][:] = 900
    d["n_pos"][:20, ::4] = (2 * np.arange(20)[:, None]
                            + rng.integers(0, 2, size=(20, 16)))
    q_edge = np.array(qtab, np.float64).copy()
    q_edge[[10, 11]] = [0.0, 1.0]
    d["q"][d["q"] < 12] = 12
    d["q"][10:20, ::29] = 10
    d["q"][10:20, 3::29] = 11
    d["pair_dist"][:4] = [0.0, 1.0, 0.0, 1.0]
    cases["nan_inf_tables"] = _euka_case(d, [s5, s3, q_edge, bfreq, ttr])
    d = _euka_rows(rng, 96, 48)
    cases["mixed"] = _euka_case(d, euka_damage_tables(rng) + list(consts))
    return cases
