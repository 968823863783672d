"""Builds and loads the port's native libraries at first use.

* The host library: g++ on the port's own copy of the JAX package's
  C++ sources (`cpp/*.cpp` beside this file, each a copy of
  `vgan_tpu/cpp/<name>.cpp`) with that directory's Makefile flags. It
  holds the seeding, finalize, graph-alignment, reconstruction, FASTQ
  and GAM codecs and keelime's overlap and window scans.
* The CUDA kernel libraries: nvcc on `csrc/sw.cu` (Smith-Waterman), on
  `csrc/tree_mcmc.cu` (soibean's tree MCMC) and on `csrc/keelime.cu`
  (keelime's batched overlap scans), each for sm_90a, a plain C
  interface loaded with ctypes.

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
