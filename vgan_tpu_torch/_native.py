"""Builds and loads the port's native libraries at first use.

* The host library: g++ on the port's own copy of the JAX package's
  C++ sources (`cpp/*.cpp` beside this file, each a copy of
  `vgan_tpu/cpp/<name>.cpp`) with that directory's Makefile flags. It
  holds the seeding, finalize, graph-alignment, reconstruction, FASTQ
  and GAM codecs and keelime's overlap and window scans.
* The CUDA kernel libraries: nvcc on `csrc/sw.cu` (Smith-Waterman), on
  `csrc/tree_mcmc.cu` (soibean's tree MCMC), on `csrc/keelime.cu`
  (keelime's batched overlap scans), on `csrc/abundance_mcmc.cu` (euka's
  abundance chain), on `csrc/haplocart.cu` (HaploCart's likelihood
  step), on `csrc/euka.cu` (euka's per-base scorer) and on
  `csrc/patristic.cu` (soibean's patristic-distance series), each for
  sm_90a, a plain C interface loaded with ctypes.

Both land in `_build/` beside this file (gitignored), named by a hash
of their sources and flags, so an edited source rebuilds and a stale
library is never loaded. A file lock serialises concurrent builders
(parallel test workers); the library is written under a temporary name
and renamed into place. Every source compiled lies under this package.
A failed build or load raises: no caller falls back to another path.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CPP_DIR = os.path.join(_PKG_DIR, "cpp")
# the source list and flags of vgan_tpu/cpp/Makefile:2-9
HOST_SRCS = [
    "gamcodec.cpp", "graphalign.cpp", "fastqreader.cpp", "mapfinalize.cpp",
    "reconstruct.cpp", "seedhits.cpp", "matchwin.cpp", "overlapbest.cpp",
]
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]
HOST_LIBS = ["-lz", "-lpthread"]
SW_SRC = os.path.join(_PKG_DIR, "csrc", "sw.cu")
TREE_MCMC_SRC = os.path.join(_PKG_DIR, "csrc", "tree_mcmc.cu")
KEELIME_SRC = os.path.join(_PKG_DIR, "csrc", "keelime.cu")
ABUNDANCE_MCMC_SRC = os.path.join(_PKG_DIR, "csrc", "abundance_mcmc.cu")
HAPLOCART_SRC = os.path.join(_PKG_DIR, "csrc", "haplocart.cu")
EUKA_SRC = os.path.join(_PKG_DIR, "csrc", "euka.cu")
PATRISTIC_SRC = os.path.join(_PKG_DIR, "csrc", "patristic.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

BUILD_SECONDS: Dict[str, float] = {}
"""Compile seconds of each library built by this process (a library
found already built is absent)."""

_loaded: Dict[str, ctypes.CDLL] = {}


def _find_tool(name: str, fallbacks: List[str]) -> str:
    for cand in [shutil.which(name)] + fallbacks:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found (needed to build the port's "
                       "native libraries)")


def _build(name: str, compiler: str, flags: List[str], srcs: List[str],
           libs: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags + libs).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            return out
        tmp = f"{out}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        r = subprocess.run(
            [compiler] + flags + ["-o", tmp] + srcs + libs,
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({compiler}, rc {r.returncode}):\n"
                f"{r.stdout}\n{r.stderr}"
            )
        os.replace(tmp, out)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def host_lib() -> ctypes.CDLL:
    """The native host library (seeding, finalize, codecs, keelime's
    scans), built from cpp/ on first use."""
    lib = _loaded.get("host")
    if lib is None:
        gxx = _find_tool("g++", [])
        path = _build("vgan_host", gxx, HOST_FLAGS,
                      [os.path.join(CPP_DIR, s) for s in HOST_SRCS],
                      HOST_LIBS)
        lib = _loaded["host"] = ctypes.CDLL(path)
    return lib


def _nvcc_lib(name: str, src: str) -> ctypes.CDLL:
    """One CUDA source built with nvcc for sm_90a and loaded."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = _find_tool("nvcc", [os.path.join(cuda_home, "bin", "nvcc")])
    return ctypes.CDLL(_build(name, nvcc, NVCC_FLAGS, [src], []))


def sw_lib() -> ctypes.CDLL:
    """The CUDA Smith-Waterman kernels (csrc/sw.cu), built with nvcc for
    sm_90a on first use, with their C entry points typed."""
    lib = _loaded.get("sw")
    if lib is None:
        lib = _nvcc_lib("vgan_sw", SW_SRC)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.sw_scores_launch.restype = i32
        lib.sw_scores_launch.argtypes = [
            vp, vp, vp, vp, vp,        # read, win, read_len, win_len, out
            i32, i32, i32,             # B, R, W
            vp,                        # stream
        ]
        lib.gather_score_hash_launch.restype = i32
        lib.gather_score_hash_launch.argtypes = [
            vp, i64,                   # pc_buf, P
            vp, i32,                   # reads_mat, Rmax
            vp, vp, i32,               # read_lens, aux [4, M] int64, M
            vp, vp, i32,               # pow1, pow2, Wmax
            vp, vp, vp,                # scores, h1, h2
            vp,                        # stream
        ]
        _loaded["sw"] = lib
    return lib


def tree_mcmc_lib() -> ctypes.CDLL:
    """The CUDA tree-MCMC kernel (csrc/tree_mcmc.cu), built with nvcc
    for sm_90a on first use, with its C entry points typed (the launch
    and the residency query of its thread-block clusters)."""
    lib = _loaded.get("tree_mcmc")
    if lib is None:
        lib = _nvcc_lib("vgan_tree_mcmc", TREE_MCMC_SRC)
        vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.tree_mcmc_segment_launch.restype = i32
        lib.tree_mcmc_segment_launch.argtypes = (
            [vp] * 4                   # carry: nodes, pos, theta, ll
            + [vp] * 7                 # mask, iters, sd, four noise arrays
            + [vp, vp, i32]            # path_map_t, counts25_t, count dtype
            + [vp] * 5                 # parent, dist, children, n_children,
                                       # freq
            + [f64]                    # con
            + [vp] * 4                 # the four trace arrays
            + [i32] * 8                # B, S, K, hops, R, P, N, Cc
            + [i32]                    # cluster: CTAs a row
            + [vp]                     # stream
        )
        lib.tree_mcmc_max_active_clusters.restype = i32
        lib.tree_mcmc_max_active_clusters.argtypes = [
            i32, i32, i32, i32, i32,   # cluster, K, N, Cc, count dtype
            ctypes.POINTER(i32),       # out: clusters resident at once
        ]
        _loaded["tree_mcmc"] = lib
    return lib


def keelime_lib() -> ctypes.CDLL:
    """The CUDA overlap-scan kernels (csrc/keelime.cu), built with nvcc
    for sm_90a on first use, with their C entry points typed."""
    lib = _loaded.get("keelime")
    if lib is None:
        lib = _nvcc_lib("vgan_keelime", KEELIME_SRC)
        _type_keelime(lib)
        _loaded["keelime"] = lib
    return lib


def _type_keelime(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_double)
    lib.overlap_warp_launch.restype = i32
    lib.overlap_warp_launch.argtypes = [
        vp, vp, vp, vp,            # seq, off [S + 1], ai, bi
        vp, vp, i64,               # order [n] int32, n_short [1] int32, n
        vp, vp,                    # lut [256] uint8, table2 [16, 16] int8
        i64, f64,                  # min_olen, min_score
        vp, vp,                    # out_len, out_score
        vp,                        # stream
    ]
    lib.overlap_best_launch.restype = i32
    lib.overlap_best_launch.argtypes = [
        vp, vp, vp, vp,            # seq, off [S + 1], ai, bi
        vp, vp, i64,               # order [n] int32, n_short [1] int32, n
        vp, vp,                    # lut [256] uint8, pair table [65536] int8
        i64, f64,                  # min_olen, min_score
        vp, vp,                    # out_len, out_score
        i32, i64,                  # cluster: CTAs a pair; clusters
        vp,                        # stream
    ]
    lib.overlap_best_max_active_clusters.restype = i32
    lib.overlap_best_max_active_clusters.argtypes = [
        i32, ctypes.POINTER(i32),  # cluster; out: clusters resident at once
    ]


_VP, _I32, _I64, _F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_double)
ABUNDANCE_MCMC_ARGTYPES = [
    _VP, _VP,                  # carry: current [T], cur_ll [1]
    _VP, _VP,                  # z [S, T], u [S]
    _VP, _VP,                  # n_reads [T], const_ll [1]
    _F64, _I32, _I64,          # alpha, T, S
    _VP,                       # out [S, T]
    _VP,                       # stream
]
"""The argument types of abundance_mcmc_segment_launch."""
ABUNDANCE_MCMC_WARPS_ARGTYPES = (ABUNDANCE_MCMC_ARGTYPES[:-1]
                                 + [_I32]  # consumer warps (0: its choice)
                                 + ABUNDANCE_MCMC_ARGTYPES[-1:])
"""The argument types of abundance_mcmc_segment_launch_warps."""
HC_NODE_SCORES_ARGTYPES = [
    _I32,                      # code bytes: 1 (uint8) or 4 (int32)
    _VP, _VP, _VP, _VP,        # g, r, q [M, S], mq [M]
    _VP, _VP, _VP,             # use_bep [M] | null, take | valid
    _VP, _VP, _VP,             # pang, node [M] int32, b [M] f64
    _VP, _I32, _VP, _I32,      # qtab, imtab and their lengths
    _VP, _I32, _VP, _I32,      # match_tab, mapp_tab
    _VP, _I32,                 # bg
    _F64, _I32,                # bep, consensus
    _I64, _I32, _I32,          # M, S, n_nodes
    _VP, _VP,                  # out: c [n_nodes], total_b [1]
    _VP,                       # stream
]
"""The argument types of hc_node_scores_launch."""
EUKA_SCORE_ARGTYPES = [
    _VP, _VP, _VP, _VP,        # g, r, q, n_pos [B, L] int32
    _VP, _VP, _VP,             # L_read [B] int32, pair_dist [B], valid
    _VP, _VP, _I32,            # sub5p, sub3p [maxlen, 4, 4], maxlen
    _VP, _I32, _VP, _I32,      # qtab, bfreq and their lengths
    _VP,                       # ttr [4, 4]
    _I64, _I32,                # B, L
    _VP, _VP,                  # out: il, nl [B]
    _VP,                       # stream
]
"""The argument types of euka_score_launch."""
EUKA_CONFIG_ARGTYPES = [_I64, _I32, _VP]  # B, L, out int32[11]
"""The argument types of euka_score_config."""
PATRISTIC_ARGTYPES = [
    _VP, _VP, _VP,             # dn, dl [nodes, leaves], dist [nodes] f64
    _VP, _VP,                  # nodes [S] int32, pos [S] f64
    _I32, _I64,                # n_leaves, S
    _VP,                       # out [S] f64
    _VP,                       # stream
]
"""The argument types of patristic_series_launch."""


def _typed_lib(key: str, name: str, src: str, fn: str,
               argtypes: list) -> ctypes.CDLL:
    lib = _loaded.get(key)
    if lib is None:
        lib = _nvcc_lib(name, src)
        getattr(lib, fn).restype = _I32
        getattr(lib, fn).argtypes = argtypes
        _loaded[key] = lib
    return lib


def abundance_mcmc_lib() -> ctypes.CDLL:
    """The CUDA abundance-chain kernel (csrc/abundance_mcmc.cu), built with
    nvcc for sm_90a on first use, with its C entry point typed."""
    lib = _loaded.get("abundance_mcmc")
    if lib is None:
        lib = _typed_lib("abundance_mcmc", "vgan_abundance_mcmc",
                         ABUNDANCE_MCMC_SRC, "abundance_mcmc_segment_launch",
                         ABUNDANCE_MCMC_ARGTYPES)
        lib.abundance_mcmc_segment_launch_warps.restype = _I32
        lib.abundance_mcmc_segment_launch_warps.argtypes = (
            ABUNDANCE_MCMC_WARPS_ARGTYPES)
        lib.abundance_mcmc_window.restype = _I32
        lib.abundance_mcmc_window.argtypes = [_I32, _I32]  # T, warps
    return lib


def haplocart_clocks_lib() -> ctypes.CDLL:
    """csrc/haplocart.cu built for measurement only, with
    -DVGAN_HC_PHASE_CLOCKS: the same entry point typed, and
    hc_phase_clocks, which reads and clears the main kernel's cycles in
    each phase summed over rows."""
    lib = _loaded.get("haplocart_clocks")
    if lib is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = _find_tool("nvcc", [os.path.join(cuda_home, "bin", "nvcc")])
        lib = ctypes.CDLL(_build("vgan_haplocart_clocks", nvcc,
                                 NVCC_FLAGS + ["-DVGAN_HC_PHASE_CLOCKS"],
                                 [HAPLOCART_SRC], []))
        lib.hc_node_scores_launch.restype = _I32
        lib.hc_node_scores_launch.argtypes = HC_NODE_SCORES_ARGTYPES
        lib.hc_phase_clocks.restype = _I32
        lib.hc_phase_clocks.argtypes = [_VP]  # out: unsigned long long [4]
        _loaded["haplocart_clocks"] = lib
    return lib


def haplocart_lib() -> ctypes.CDLL:
    """The CUDA HaploCart likelihood-step kernel (csrc/haplocart.cu),
    built with nvcc for sm_90a on first use, with its C entry point
    typed."""
    return _typed_lib("haplocart", "vgan_haplocart", HAPLOCART_SRC,
                      "hc_node_scores_launch", HC_NODE_SCORES_ARGTYPES)


def euka_build(name: str, flags: List[str], src: str = EUKA_SRC
               ) -> ctypes.CDLL:
    """`src` (by default csrc/euka.cu) built with nvcc for sm_90a and the
    extra `flags` as library `name`, its entry points typed:
    euka_score_launch, and euka_score_config where the source has it.
    Besides the library (no flags): the builds for measurement and tests
    (-DVGAN_EUKA_PHASE_CLOCKS, -DVGAN_EUKA_TABLES_L1,
    -DVGAN_EUKA_SCALAR_LOADS, -DVGAN_EUKA_MIN_BLOCKS=N, ptxas levels) and
    other commits' sources."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = _find_tool("nvcc", [os.path.join(cuda_home, "bin", "nvcc")])
    lib = ctypes.CDLL(_build(name, nvcc, NVCC_FLAGS + list(flags), [src], []))
    for fn, argtypes in (("euka_score_launch", EUKA_SCORE_ARGTYPES),
                         ("euka_score_config", EUKA_CONFIG_ARGTYPES)):
        if fn == "euka_score_launch" or hasattr(lib, fn):
            getattr(lib, fn).restype = _I32
            getattr(lib, fn).argtypes = argtypes
    return lib


def euka_clocks_lib() -> ctypes.CDLL:
    """csrc/euka.cu built for measurement only, with
    -DVGAN_EUKA_PHASE_CLOCKS: the same entry points typed, and
    euka_phase_clocks, which reads and clears the kernel's cycles in each
    phase (see the source)."""
    lib = _loaded.get("euka_clocks")
    if lib is None:
        lib = euka_build("vgan_euka_clocks", ["-DVGAN_EUKA_PHASE_CLOCKS"])
        lib.euka_phase_clocks.restype = _I32
        lib.euka_phase_clocks.argtypes = [_VP]  # out: unsigned long long [20]
        _loaded["euka_clocks"] = lib
    return lib


def euka_lib() -> ctypes.CDLL:
    """The CUDA euka scorer kernel (csrc/euka.cu), built with nvcc for
    sm_90a on first use, with its C entry points typed."""
    lib = _loaded.get("euka")
    if lib is None:
        lib = euka_build("vgan_euka", [])
        _loaded["euka"] = lib
    return lib


def patristic_lib() -> ctypes.CDLL:
    """The CUDA patristic-distance series kernel (csrc/patristic.cu),
    built with nvcc for sm_90a on first use, with its C entry point
    typed."""
    return _typed_lib("patristic", "vgan_patristic", PATRISTIC_SRC,
                      "patristic_series_launch", PATRISTIC_ARGTYPES)
