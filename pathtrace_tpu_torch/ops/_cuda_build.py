"""Build the package's CUDA kernels (``csrc/*.cu``) at first use.

Every source compiles in its own ``nvcc -c`` process, all started
together; one ``nvcc -shared`` then links the objects into a shared
library with a plain C interface, loaded with ``ctypes``. The library lands in
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
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-shared")

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
    "pt_sphere_nearest_moving": [
        _c_void_p, _c_longlong,                  # rays, row stride
        _c_void_p, _c_int,                       # time, n_rays
        _c_void_p, _c_int,                       # soa [12, N], n_spheres
        _c_float, _c_float,                      # t_min, t_max
        _c_void_p, _c_void_p, _c_void_p,         # t_out, idx_out, stream
    ],
    "pt_shade_from_winners": [
        _c_void_p, _c_int,                       # table, k_attr
        _c_void_p, _c_int,                       # atlas or NULL, atlas width
        _c_void_p, _c_void_p,                    # idx, t
        _c_void_p, _c_longlong,                  # planes, plane stride
        _c_void_p, _c_void_p, _c_void_p, _c_int,  # time, alive, lane, n
        _c_int, _c_int, _c_int,                  # seed, depth, max_depth
        _c_void_p, _c_int,                       # sky4, flags
        _c_void_p, _c_void_p, _c_void_p,         # planes_out, alive_out, stream
    ],
    "pt_sphere_nearest_bwd": [
        _c_void_p, _c_void_p, _c_void_p,         # ro, rd ([R, 3]), time or NULL
        _c_void_p, _c_void_p, _c_void_p, _c_int,  # t, idx, g_t, n_rays
        _c_void_p, _c_void_p, _c_void_p,         # center, delta, time0
        _c_void_p, _c_void_p, _c_int,            # inv_dt, radius, n_spheres
        _c_float, _c_float,                      # t_min, t_max
        _c_void_p, _c_void_p, _c_void_p,         # g_ro, g_rd, g_time
        _c_void_p, _c_void_p, _c_void_p,         # g_center, g_delta, g_time0
        _c_void_p, _c_void_p,                    # g_inv_dt, g_radius
        _c_void_p, _c_void_p,                    # partial, mid or NULL
        _c_int, _c_int, _c_void_p,               # blocks, shared, stream
    ],
    "pt_sphere_nearest_culled": [
        _c_void_p, _c_longlong, _c_int,          # rays, row stride, n_rays
        _c_void_p, _c_int,                       # soa, n_spheres (row stride)
        _c_void_p, _c_int,                       # tile boxes, n_tiles
        _c_void_p, _c_int,                       # supertile boxes or NULL, s_tiles
        _c_float, _c_float,                      # t_min, t_max
        _c_void_p, _c_void_p,                    # t_out, idx_out
        _c_void_p, _c_void_p,                    # sweep counter or NULL, stream
    ],
    "pt_sphere_nearest_culled_rays": [_c_int, _c_int],  # n_rays, hier
    "pt_megakernel": [
        _c_void_p, _c_void_p, _c_void_p, _c_int,  # ro, rd, time, n_rays
        _c_void_p, _c_void_p,                    # sphere table, resident rows
        _c_int, _c_int,                          # static rows, moving rows
        _c_void_p, _c_void_p, _c_int,            # rect table, rows, count
        _c_void_p,                               # sky4
        _c_int, _c_int, _c_int, _c_float,        # seed, max_depth, flags, t_min
        _c_void_p, _c_void_p, _c_void_p,         # out, counts, stream
    ],
    "pt_megakernel_shared_bytes": [_c_int, _c_int, _c_int, _c_int],
    "pt_sphere_min_t": [
        _c_void_p, _c_longlong, _c_int,          # cols [6, R], row stride, R
        _c_void_p, _c_int, _c_int,               # rows [4, N], N, bf16
        _c_void_p, _c_void_p,                    # t_out, stream
    ],
    "pt_sphere_min_t_rays": [_c_int],             # bf16
    "pt_sum_split": [
        ctypes.POINTER(_c_void_p), _c_int,       # host array of plane ptrs, K
        _c_longlong, _c_void_p, _c_void_p,       # elements a plane, out, stream
    ],
    "pt_sum_minor": [
        _c_void_p, _c_int, _c_longlong,          # (rows, K, 128), K, rows*128
        _c_void_p, _c_void_p,                    # out, stream
    ],
    "pt_sum_major": [
        _c_void_p, _c_int, _c_longlong,          # (K, rows, 128), K, rows*128
        _c_void_p, _c_void_p,                    # out, stream
    ],
    "pt_threefry": [
        ctypes.c_uint, ctypes.c_uint, _c_longlong,  # key words, n draws
        _c_int, _c_void_p, _c_void_p,            # as_float, out, stream
    ],
    "pt_bvh_traverse": [
        _c_void_p, _c_longlong, _c_int,          # rays [6, R], row stride, R
        _c_void_p,                               # time [R] or NULL
        _c_void_p, _c_int, _c_int,               # nodes, n_nodes, float4 rows
        _c_void_p, _c_void_p,                    # prim records, flights or NULL
        _c_int, _c_int, _c_int, _c_int,          # rect, box, medium starts, flags
        _c_float, _c_float,                      # t_min, t_max
        _c_void_p, _c_void_p, _c_void_p,         # t_out, gid_out, visits or NULL
        _c_void_p,                               # stream
    ],
    "pt_bvh_wide_traverse": [
        _c_void_p, _c_longlong, _c_int,          # rays [6, R], row stride, R
        _c_void_p,                               # time [R] or NULL
        _c_void_p, _c_int, _c_int,               # nodes, n_nodes, float4 rows
        _c_int, _c_int, _c_int,                  # leaf_m, slot base, slot floats
        _c_void_p, _c_void_p,                    # prim records, flights or NULL
        _c_int, _c_int, _c_int, _c_int,          # rect, box, medium starts, flags
        _c_float, _c_float,                      # t_min, t_max
        _c_void_p, _c_void_p, _c_void_p,         # t_out, gid_out, visits or NULL
        _c_void_p,                               # stream
    ],
    "pt_box_media_nearest": [
        _c_void_p, _c_longlong, _c_int,          # rays [6, R], row stride, R
        _c_void_p, _c_int,                       # box records, n_boxes
        _c_void_p, _c_int,                       # media records, n_media
        _c_void_p, _c_float, _c_float,           # flights, t_min, t_max
        _c_void_p, _c_void_p,                    # box t, idx
        _c_void_p, _c_void_p, _c_void_p,         # media t, idx, stream
    ],
    "pt_bvh_traverse_plan": [_c_int, _c_int, _c_void_p],  # R, flags, int[3]
    "pt_noise_turb_plan": [_c_int, _c_void_p],  # n, int[4]
    "pt_noise_turb": [
        _c_void_p, _c_void_p, _c_int,            # points [n, 3], mask, n
        _c_void_p, _c_void_p, _c_void_p,         # out, list [n], stream
    ],
    "pt_cuda_error_string": [_c_int],
}


class BuildInfo(NamedTuple):
    path: Path
    seconds: float   # nvcc wall time (compiles and link); 0.0 when reused
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
    digest.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildInfo(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = os.getpid()
    t0 = time.monotonic()
    jobs = []
    for src in (p for p in srcs if p.suffix == ".cu"):
        obj = out_dir / f".{src.stem}.{tag}.o"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    logs, failed = [], []
    for src, obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    tmp = out_dir / f".{LIB_NAME}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, *LINK_FLAGS, "-o", str(tmp), *[str(o) for _, o, _ in jobs]],
        capture_output=True, text=True)
    seconds = time.monotonic() - t0
    log += link.stdout + link.stderr
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
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
            fn.restype = {"pt_cuda_error_string": ctypes.c_char_p,
                          "pt_megakernel_shared_bytes": _c_longlong}.get(
                              name, _c_int)
        _LIB = lib
    return _LIB


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = library().pt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
