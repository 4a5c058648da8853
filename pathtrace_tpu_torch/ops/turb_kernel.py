"""The marble texture's hash turbulence on the lanes that wear it: the
CUDA kernel of ``csrc/turb.cu`` and its plain PyTorch version.

It replaces no TPU kernel. The reference's non-fused bounce computes the
7-octave turbulence ``fast_turb_c`` in XLA for every lane
(``pathtrace_tpu/ops/fastpath.py:460-497``); the port's twin,
:func:`~pathtrace_tpu_torch.ops.fastpath.fast_turb_c`, is ~5,000
element-wise launches over the whole wavefront. The kernel computes it
with ``csrc/pt_device.cuh``'s ``fast_turb`` (the function K2 and K7
evaluate inline, bit for bit the twin), one thread a lane, only where the
mask is set (the winner wears the noise texture); other lanes get 0.

:func:`noise_turb` is a ``torch.autograd.Function``: the forward is the
kernel (the plain version on the CPU), the backward runs the plain
version again under autograd on the saved points of the masked-in lanes
and scatters their gradient back (the others get 0). That is the
gradient the plain path gives; the reference differentiates XLA code
here and has no backward kernel.

CPU tensors run the plain version; CUDA tensors launch the kernel on the
current stream; any other device raises. ``LAUNCHES`` counts the
kernel's launches, ``PLAIN_CALLS`` the forwards the plain version served,
``BWD_PLAIN_CALLS`` the backwards (plain on every device).
"""

from __future__ import annotations

import torch

THREADS = 256    # threads a block of both passes (csrc/turb.cu)
LIST_LANES = 4   # lanes a thread of the list pass
LAUNCHES = 0     # kernel launches (CUDA tensors)
PLAIN_CALLS = 0  # forwards the plain version served (CPU tensors)
BWD_PLAIN_CALLS = 0  # backwards (the plain version's, on any device)


def turb_plain(point: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[R] turbulence of the points [R, 3] where ``mask`` [R] is set, 0
    elsewhere."""
    from pathtrace_tpu_torch.ops.fastpath import fast_turb_c

    turb = fast_turb_c(point[:, 0], point[:, 1], point[:, 2])
    return torch.where(mask, turb, 0.0)


def _launch(point: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    from pathtrace_tpu_torch.ops import _cuda_build

    point = point.detach().to(torch.float32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    R = point.shape[0]
    out = torch.empty(R, dtype=torch.float32, device=point.device)
    if R:
        # the list of masked-in lanes, filled on the card
        lanes = torch.empty(R, dtype=torch.int32, device=point.device)
        code = _cuda_build.library().pt_noise_turb(
            point.data_ptr(), mask.data_ptr(), R, out.data_ptr(),
            lanes.data_ptr(),
            torch.cuda.current_stream(point.device).cuda_stream)
        _cuda_build.check(code, "noise_turb launch")
        LAUNCHES += 1
    return out


class NoiseTurb(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU); backward: the
    plain version's gradient."""

    @staticmethod
    def forward(ctx, point, mask):
        global PLAIN_CALLS
        ctx.save_for_backward(point, mask)
        if point.device.type == "cpu":
            PLAIN_CALLS += 1
            return turb_plain(point, mask)
        if point.device.type != "cuda":
            raise ValueError(f"noise_turb: unsupported device {point.device}")
        return _launch(point, mask)

    @staticmethod
    def backward(ctx, grad):
        global BWD_PLAIN_CALLS
        from pathtrace_tpu_torch.ops.fastpath import fast_turb_c

        BWD_PLAIN_CALLS += 1
        point, mask = ctx.saved_tensors
        g_point = torch.zeros_like(point)
        with torch.enable_grad():
            p = point.detach()[mask].requires_grad_(True)
            turb = fast_turb_c(p[:, 0], p[:, 1], p[:, 2])
            (g_noise,) = torch.autograd.grad(turb, p, grad[mask])
        g_point[mask] = g_noise
        return g_point, None


def noise_turb(point: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[R] ``fast_turb_c`` of the points [R, 3] on the lanes ``mask`` [R]
    (bool) selects, 0 on the others."""
    if point.dim() != 2 or point.shape[1] != 3 or mask.shape != point.shape[:1]:
        raise ValueError(f"noise_turb takes points [R, 3] and a mask [R], got "
                         f"{tuple(point.shape)} and {tuple(mask.shape)}")
    return NoiseTurb.apply(point, mask)


def launch_plan(n: int, sms: int, per_sm: int) -> dict:
    """The grids ``pt_noise_turb`` launches for ``n`` lanes on a card of
    ``sms`` SMs where ``per_sm`` octave blocks fit (the occupancy the C
    side asks the runtime for; ``pt_noise_turb_plan`` gives it): the list
    pass four lanes a thread; the octave pass every resident block, no more
    than ``n`` listed lanes at eight threads each could fill."""
    return {"list_blocks": -(-n // (THREADS * LIST_LANES)),
            "octave_blocks": max(1, min(sms * per_sm, -(-8 * n // THREADS)))}


def yardsticks(R: int, noise_lanes: int) -> dict:
    """The least time the card could take for the turbulence of ``R``
    lanes of which ``noise_lanes`` are masked in: their operations at one
    instruction each (``nearest_bench.NOISE_OPS``, 1708, K2's count for
    the same function) over the 33.5 T/s issue rate, against the bytes
    the function must move: the mask in and the value out (5 a lane) and
    the points of the masked-in lanes (12 each; the kernel reads no
    other)."""
    from pathtrace_tpu_torch.tools._probe import HBM_BYTES_PER_S, ISSUE_PER_S
    from pathtrace_tpu_torch.tools.nearest_bench import NOISE_OPS

    ops = NOISE_OPS * noise_lanes
    nbytes = 5 * R + 12 * noise_lanes
    ops_ms = ops / ISSUE_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "issue_ceiling_ms": ops_ms, "bytes_ms": bytes_ms,
            "operations": ops, "bytes": nbytes}
