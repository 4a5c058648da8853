"""Probe: does a bf16 sphere sweep beat the float32 one on the card, and
how far does it move t?

    python -m pathtrace_tpu_torch.tools.bf16_probe
    python -m pathtrace_tpu_torch.tools.bf16_probe --device cpu --rays 4096 --spheres 256

The port of the JAX package's ``tools/bf16_probe.py``. :func:`sphere_min_t`
(P1, ``csrc/bf16_probe.cu``) replaces its TPU kernel ``make_kernel(dtype)``
(``pallas_call`` at ``:81``): per ray, the minimum over every sphere of
``-b - sqrt(disc)`` where ``disc > 0``, else 1e30, the quadratic in
``dtype`` (float32 or bf16), the sqrt and the minimum in float32. It is
bound by operations, 22 per ray-sphere pair, 16 of them in ``dtype``; the
bf16 instance packs two spheres per ``__nv_bfloat162`` to run those at the
CUDA cores' packed bf16 rate. A thread sweeps 4 rays in float32, 2 in
bf16 (``RAYS_PER_THREAD``), over sphere rows staged as one 16-byte row a
slot. :func:`sphere_min_t_plain` is its plain PyTorch version, which the
kernel equals bit for bit in both types. The operation counts behind
:func:`bound` and :func:`issue_ceiling` are kept here, in one place.

The entry point runs on the card unless ``--device cpu`` is given (then
the plain versions run); without a card the default exits non-zero. At
the reference's size (``--rays 1048576 --spheres 640``) and with its input
distributions: six ray columns uniform in [0, 1) (directions not
normalised), sphere rows cx, cy, cz, c2 uniform in [0, 20). They come
from a seeded ``torch.Generator`` on the device, which cannot give
``jax.random``'s bits: the numbers differ from the reference's, the
distributions do not. For each type it prints one JSON line:

- ``bench``: ``bf16_probe/f32`` or ``bf16_probe/bf16``;
- ``ms``: the reference's clock, host wall time of one call plus a
  readback of the sum, best of 4, with ``cols[0] + e`` varied each time;
- ``kernel_ms``: the kernel alone, device time from CUDA events
  (``_probe.event_ms``; null on the CPU);
- ``bound_ms`` and ``bound_by``, ``issue_ceiling_ms`` (null on the CPU);
- ``share_outside_f32``: the share of rays whose t leaves the float32
  result's by more than 1e-3 (rel and abs); 0 for f32;
- ``miss_flips``: rays that hit (t < 1e30) in one type and miss in the
  other;
- ``device``: ``nvidia-smi``'s name and power limit, or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from pathtrace_tpu_torch.tools import _probe

LAUNCHES = 0     # kernel launches (CUDA tensors)
PLAIN_CALLS = 0  # calls the wrapper served with the plain version (CPU)

TILE_N = 128      # spheres per tile of the plain version (the reference's)
MISS_T = 1e30     # t of a ray that hits no sphere
PLAIN_CHUNK = 1 << 15  # rays per plain-version chunk ([chunk, 128] temps)
OUTSIDE_TOL = 1e-3     # rel and abs tolerance of share_outside_f32
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# operations per ray-sphere pair, counted from the plain version: 16 in
# the quadratic's type (b 6, c 8, disc 2), 6 in float32 (compare, sqrt,
# the root's negation and subtraction, select, min); per ray 10 more in the
# type (|ro|^2 and ro.d)
OPS_PAIR_DTYPE, OPS_PAIR_F32, OPS_RAY_DTYPE = 16, 6, 10
# as instructions: the bf16 instance runs two pairs' quadratic in one
# bf16x2 instruction and unpacks each pair's b and disc to float32 (2 a
# pair); its per-ray terms, broadcast to both halves, are 10 bf16x2
# instructions
UNPACKS_PAIR_BF16 = 2
# rays a thread (csrc/bf16_probe.cu kRaysOf; the launcher's own answer is
# kernel_rays_per_thread)
RAYS_PER_THREAD = {"f32": 4, "bf16": 2}


def _check(cols: torch.Tensor, rows: torch.Tensor, dtype) -> None:
    if dtype not in DTYPES.values():
        raise TypeError(f"sphere_min_t: dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    if cols.device != rows.device:
        raise ValueError(f"cols on {cols.device}, rows on {rows.device}")
    if cols.dtype != torch.float32 or rows.dtype != torch.float32:
        raise TypeError("sphere_min_t takes float32 tensors")
    if cols.dim() != 2 or cols.shape[0] != 6:
        raise ValueError(f"cols must be [6, R], got {tuple(cols.shape)}")
    if rows.dim() != 2 or rows.shape[0] != 4:
        raise ValueError(f"rows must be [4, N], got {tuple(rows.shape)}")
    if cols.stride(1) != 1 or not rows.is_contiguous():
        raise ValueError("cols' rows must be unit-stride and rows contiguous")


def sphere_min_t_plain(cols: torch.Tensor, rows: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of P1, the reference's expression operation
    for operation: ``cols`` [6, R] (ro xyz, rd xyz), ``rows`` [4, N] (cx,
    cy, cz, c2), both float32; the quadratic in ``dtype``, every bf16
    operation rounded on its own; t [R] float32."""
    t_out = torch.full((cols.shape[1],), MISS_T, dtype=torch.float32,
                       device=cols.device)
    for lo, b, disc in _quadratics(cols, rows, dtype):
        # float64 root rounded once = the correctly rounded float32 sqrt
        # (torch's CPU float32 sqrt can be one ULP off)
        sq = torch.sqrt(torch.clamp(disc, min=0).double()).float()
        t = torch.where(disc > 0, (-b).float() - sq, MISS_T)
        best = t_out[lo:lo + PLAIN_CHUNK]
        torch.minimum(best, t.min(dim=1).values, out=best)
    return t_out


def _quadratics(cols: torch.Tensor, rows: torch.Tensor, dtype):
    """(first ray, b, disc) for each chunk of ``PLAIN_CHUNK`` rays and
    tile of ``TILE_N`` spheres: the reference's quadratic in ``dtype``,
    [chunk, tile] each."""
    R, N = cols.shape[1], rows.shape[1]
    sph = rows.to(dtype)
    for lo in range(0, R, PLAIN_CHUNK):
        ro_x, ro_y, ro_z, rd_x, rd_y, rd_z = (
            cols[k, lo:lo + PLAIN_CHUNK].to(dtype)[:, None] for k in range(6))
        ro_d = ro_x * rd_x + ro_y * rd_y + ro_z * rd_z
        ro_ro = ro_x * ro_x + ro_y * ro_y + ro_z * ro_z
        for s0 in range(0, N, TILE_N):
            scx, scy, scz, sc2 = (sph[k, None, s0:s0 + TILE_N]
                                  for k in range(4))
            b = ro_d - (scx * rd_x + scy * rd_y + scz * rd_z)
            c = ro_ro - 2.0 * (scx * ro_x + scy * ro_y + scz * ro_z) + sc2
            yield lo, b, b * b - c


def sphere_min_t(cols: torch.Tensor, rows: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """P1 for every ray: t [R] float32 (see :func:`sphere_min_t_plain`).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (raising if it cannot launch)."""
    global LAUNCHES, PLAIN_CALLS
    _check(cols, rows, dtype)
    if cols.device.type == "cpu":
        PLAIN_CALLS += 1
        return sphere_min_t_plain(cols, rows, dtype)
    if cols.device.type != "cuda":
        raise ValueError(f"sphere_min_t: unsupported device {cols.device}")
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    R, N = cols.shape[1], rows.shape[1]
    t_out = torch.empty(R, dtype=torch.float32, device=cols.device)
    if R == 0:
        return t_out
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    code = lib.pt_sphere_min_t(
        cols.data_ptr(), cols.stride(0), R, rows.data_ptr(), N,
        int(dtype == torch.bfloat16), t_out.data_ptr(), stream)
    _cuda_build.check(code, "sphere_min_t launch")
    LAUNCHES += 1
    return t_out


def kernel_rays_per_thread(dtype) -> int:
    """The rays a thread the kernel launches ``dtype``'s instance with (its
    C entry ``pt_sphere_min_t_rays``); :data:`RAYS_PER_THREAD` mirrors it."""
    from pathtrace_tpu_torch.ops import _cuda_build

    return int(_cuda_build.library().pt_sphere_min_t_rays(
        int(dtype == torch.bfloat16)))


def make_inputs(n_rays: int, n_spheres: int, seed: int,
                device: torch.device):
    """The reference probe's distributions: cols [6, R] uniform in [0, 1),
    rows [4, N] uniform in [0, 20)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cols = torch.rand(6, n_rays, generator=gen, device=device)
    rows = torch.rand(4, n_spheres, generator=gen, device=device) * 20.0
    return cols, rows


def compare(t: torch.Tensor, t_f32: torch.Tensor):
    """(share of rays outside OUTSIDE_TOL of ``t_f32``, rays that hit in
    one and miss in the other)."""
    a, b = t.double(), t_f32.double()
    close = (a - b).abs() <= OUTSIDE_TOL + OUTSIDE_TOL * b.abs()
    flips = int(((t < MISS_T) != (t_f32 < MISS_T)).sum())
    return 1.0 - close.double().mean().item() if t.numel() else 0.0, flips


def bound(n_rays: int, n_spheres: int, dtype):
    """(bound_ms, bound_by) on the card: the larger of the bytes (six ray
    columns read, t written, the rows read once) over the HBM rate and
    the operations, each type's at its peak."""
    pairs = n_rays * n_spheres
    rate = (_probe.BF16_FLOP_PER_S if dtype == torch.bfloat16
            else _probe.FP32_FLOP_PER_S)
    by_ops = ((pairs * OPS_PAIR_DTYPE + n_rays * OPS_RAY_DTYPE) / rate
              + pairs * OPS_PAIR_F32 / _probe.FP32_FLOP_PER_S) * 1e3
    by_bytes = _bytes_ms(n_rays, n_spheres)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _bytes_ms(n_rays: int, n_spheres: int) -> float:
    return (n_rays * 7 + n_spheres * 4) * 4 / _probe.HBM_BYTES_PER_S * 1e3


def issue_ceiling(n_rays: int, n_spheres: int, dtype) -> float:
    """The least time (ms) at one warp instruction a clock on every SM
    sub-partition when each operation is one instruction (``-fmad=false``):
    22 a pair in float32; in bf16 the quadratic's 16 as 8 bf16x2
    instructions, 2 unpacks and 6 float32; 10 a ray; or the bytes, if
    longer."""
    pairs = n_rays * n_spheres
    if dtype == torch.bfloat16:
        per_pair = OPS_PAIR_DTYPE / 2 + UNPACKS_PAIR_BF16 + OPS_PAIR_F32
    else:
        per_pair = OPS_PAIR_DTYPE + OPS_PAIR_F32
    by_issue = ((pairs * per_pair + n_rays * OPS_RAY_DTYPE)
                / _probe.ISSUE_PER_S * 1e3)
    return max(by_issue, _bytes_ms(n_rays, n_spheres))


def positive_share(cols: torch.Tensor, rows: torch.Tensor,
                   dtype=torch.float32) -> float:
    """Share of ray-sphere pairs with disc > 0 (the pairs that take the
    root), from the plain version's quadratic."""
    hits = sum(int((disc > 0).sum()) for _, _, disc in
               _quadratics(cols, rows, dtype))
    return hits / max(cols.shape[1] * rows.shape[1], 1)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="bf16_probe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--spheres", type=int, default=640)
    args = ap.parse_args(argv)

    dev = _probe.probe_device(args.device, "bf16_probe")
    if dev is None:
        return 1
    card = _probe.device_line(dev)
    on_card = dev.type == "cuda"
    cols, rows = make_inputs(args.rays, args.spheres, 0, dev)
    work = cols.clone()
    t_f32 = None
    for name, dtype in DTYPES.items():
        def run(i, dtype=dtype):
            torch.add(cols[0], i * 1e-6, out=work[0])
            return sphere_min_t(work, rows, dtype).sum().item()

        ms = _probe.best_wall_ms(run)
        kernel_ms = (_probe.event_ms(lambda: sphere_min_t(cols, rows, dtype))
                     if on_card else None)
        t = sphere_min_t(cols, rows, dtype)
        if t_f32 is None:
            t_f32 = t
        outside, flips = compare(t, t_f32)
        bnd = bound(args.rays, args.spheres, dtype) if on_card else (None, None)
        print(json.dumps({
            "bench": f"bf16_probe/{name}", "ms": ms, "kernel_ms": kernel_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "issue_ceiling_ms": (issue_ceiling(args.rays, args.spheres, dtype)
                                 if on_card else None),
            "share_outside_f32": outside, "miss_flips": flips,
            "rays": args.rays, "spheres": args.spheres, "device": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
