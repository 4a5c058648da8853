"""Build the package's CUDA kernels (``csrc/*.cu``) at first use.

One ``nvcc -shared`` build of every source into a shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``build/pathtrace_tpu_torch/<hash>/`` beside the package, keyed by a hash
of the sources and flags: a rerun reuses it, an edited source rebuilds.
Only the repository's sources and the installed CUDA toolkit are used.

Nothing here runs at import: :func:`library` builds and loads on its
first call, which only a launch on a CUDA tensor makes.

Numerics: ``-fmad=false`` stops nvcc from contracting ``a*b+c`` into an
FMA, and IEEE division and square root stay on (no fast math), so every
``+ - * / sqrt`` rounds as IEEE float32 does, one operation at a time,
like PyTorch's CUDA elementwise kernels. ``-Xptxas -v`` leaves each
kernel's register and shared-memory use in the build log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "pathtrace_tpu_torch"
LIB_NAME = "libpathtrace_kernels.so"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_c_longlong = ctypes.c_longlong

# argtypes of every launcher (each returns its cudaGetLastError() code)
_SIGNATURES = {
    "pt_sphere_nearest": [
        _c_void_p, _c_longlong, _c_int,          # rays, row stride, n_rays
        _c_void_p, _c_int,                       # soa, n_spheres (row stride)
        _c_float, _c_float,                      # t_min, t_max
        _c_void_p, _c_void_p, _c_void_p,         # t_out, idx_out, stream
    ],
    "pt_shade_from_winners": [
        _c_void_p, _c_int,                       # table, k_attr
        _c_void_p, _c_void_p,                    # idx, t
        _c_void_p, _c_longlong,                  # planes, plane stride
        _c_void_p, _c_void_p, _c_void_p, _c_int,  # time, alive, lane, n
        _c_int, _c_int, _c_int,                  # seed, depth, max_depth
        _c_void_p, _c_int,                       # sky4, flags
        _c_void_p, _c_void_p, _c_void_p,         # planes_out, alive_out, stream
    ],
    "pt_cuda_error_string": [_c_int],
}


class BuildInfo(NamedTuple):
    path: Path
    seconds: float   # nvcc wall time; 0.0 when an earlier build was reused
    log: str         # nvcc/ptxas output of this build ("" when reused)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> BuildInfo:
    """Compile the kernels unless a library for these sources exists."""
    srcs = _sources()
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildInfo(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in srcs if p.suffix == ".cu"]]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    (out_dir / "build.log").write_text(log)
    return BuildInfo(lib, seconds, log)


_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _c_int if name != "pt_cuda_error_string" else ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = library().pt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
