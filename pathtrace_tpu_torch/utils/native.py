"""ctypes binding of the native BVH builder (counterpart of
``pathtrace_tpu/utils/native.py``).

The builder is the repository's ``native/bvh_builder.cpp`` (its C entry
``ptpu_build_bvh_v2``: the random-axis median split or the full-sweep
SAH, emitted in DFS pre-order with escape indices). It is read as a
source only: the first call compiles it with ``g++`` into
``build/pathtrace_tpu_torch_native/<hash>/`` beside the kernels'
builds (keyed by the source and the flags, so an edited source
rebuilds), and nothing is written into ``native/``.

``-ffp-contract=off`` keeps the SAH's float area sums from being fused
into FMAs, so they round as numpy's do and the native tree equals the
numpy builder's node for node. A failed build or load raises: the caller
asked for the native builder, and there is no quiet fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from pathtrace_tpu_torch.ops._cuda_build import BUILD_ROOT as _KERNEL_ROOT

BUILD_ROOT = _KERNEL_ROOT.parent / "pathtrace_tpu_torch_native"
SOURCE = Path(__file__).resolve().parents[2] / "native" / "bvh_builder.cpp"
LIB_NAME = "libpathtrace_bvh.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")
STRATEGIES = {"median": 0, "sah": 1}

_LIB: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the builder unless a library of this source exists."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    out_dir = BUILD_ROOT / digest[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
         str(SOURCE)],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native BVH builder: g++ failed "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded builder (compiled on the first call); raises if it
    cannot be built or loaded."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.ptpu_build_bvh_v2.restype = ctypes.c_int32
        lib.ptpu_build_bvh_v2.argtypes = [
            f32p, f32p, i32p, ctypes.c_int32, ctypes.c_uint64,
            ctypes.c_int32,
            f32p, f32p, i32p, i32p, i32p,
        ]
        _LIB = lib
    return _LIB


def native_build_bvh(bb_min: np.ndarray, bb_max: np.ndarray, ids: np.ndarray,
                     seed: int, strategy: str = "median"
                     ) -> Tuple[dict, Tuple[int, int, int]]:
    """Build the flattened tree over the primitives ``ids`` of the AABBs
    ``bb_min``/``bb_max`` [P, 3]: ({"bb_min", "bb_max", "escape",
    "prim"} numpy arrays, (node_count, leaf_count, max_depth)). The
    median split seeds the builder's xorshift with ``seed`` (1 for 0, as
    the reference does). Raises if the builder fails."""
    lib = library()
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    ids = np.ascontiguousarray(ids, np.int32)
    n = ids.shape[0]
    m_max = 2 * n - 1 if n > 1 else 1
    out_min = np.empty((m_max, 3), np.float32)
    out_max = np.empty((m_max, 3), np.float32)
    out_escape = np.empty(m_max, np.int32)
    out_prim = np.empty(m_max, np.int32)
    out_stats = np.zeros(3, np.int32)
    m = lib.ptpu_build_bvh_v2(
        bb_min, bb_max, ids, n, np.uint64(seed if seed else 1),
        STRATEGIES[strategy], out_min, out_max, out_escape, out_prim,
        out_stats)
    if m <= 0:
        raise RuntimeError(f"native BVH builder returned {m} for {n} "
                           "primitives")
    arrays = {"bb_min": out_min[:m].copy(), "bb_max": out_max[:m].copy(),
              "escape": out_escape[:m].copy(), "prim": out_prim[:m].copy()}
    return arrays, tuple(int(x) for x in out_stats)
