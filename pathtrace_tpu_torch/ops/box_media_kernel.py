"""Closest hit over a scene's boxes and media: the CUDA kernel of
``csrc/box_media_nearest.cu`` and its plain PyTorch version.

It replaces no TPU kernel. The reference sweeps boxes and media in XLA
(``pathtrace_tpu/ops/intersect.py:445`` ``box_nearest``, ``:606``
``media_nearest``), as [R, N] element-wise arrays; the plain version is
the port's twin of that, :func:`~pathtrace_tpu_torch.ops.intersect_box.box_nearest_rn`
and ``media_nearest_rn``, ~91 launches a chunk of 2^23 (ray, primitive)
pairs. The kernel takes one thread a ray, the records in shared memory,
both kinds in one launch, and gives each kind's winner (t, idx) bit for
bit the plain version's, so the callers merge the kinds in the
reference's order as before (spheres, rects, boxes, media, each winning
only when strictly nearer).

The records (:func:`pack_boxes`, :func:`pack_media`) are packed once a
scene by :func:`box_media_operand`, next to the other tables
(``fastpath.prep_tables``, ``trace_fast_diff``, ``integrator.prep_tables``),
as a :class:`BoxMediaOperand`, which also
keeps the ``Boxes`` / ``Media`` for the plain version and for the
gradient. The media's free flights ``-log(max(u, 1e-38)) / density``
are computed by PyTorch as [n_media, R] (:func:`media_flights`), in the
plain version's operations, so the kernel has no log.

Gradients: the [R, N] form's t is a gather at the argmin, so only the
winner's leaves get a gradient. Where autograd needs t,
:func:`box_media_hits` recomputes the winner's t from its primitive
gathered at idx (:func:`box_winner_t`, :func:`media_winner_t`), by the
[R, N] form's own candidate functions (``intersect_box.box_candidate``,
``media_candidate``): that t is bit for bit the kernel's, and its gradient is
the [R, N] form's (per ray the same; the leaves' sums in another order).

CPU tensors run the plain version; CUDA tensors launch the kernel on the
current stream; any other device raises. ``LAUNCHES`` counts the
kernel's launches, ``PLAIN_CALLS`` the calls the plain version served.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pathtrace_tpu_torch.config import MAX_T, MIN_T
from pathtrace_tpu_torch.models.types import (
    MEDIUM_SPHERE, Boxes, Media, Scene, SceneFeatures,
)
from pathtrace_tpu_torch.ops.intersect_box import (
    box_candidate, box_nearest_rn, media_candidate, media_nearest_rn,
)

LAUNCHES = 0     # kernel launches (CUDA tensors)
PLAIN_CALLS = 0  # calls the plain version served (CPU tensors)

_INF = float(MAX_T)
BOX_W = 20       # floats a box record: 5 rows of 4
MEDIA_W = 24     # floats a medium record: 6 rows of 4

# operations a pair (one instruction each under -fmad=false; a division
# and a sqrt count 1), counted from the plain version: two affine maps
# (18 + 15), three slabs (abs, compare, select, division, 2 subtractions,
# 2 products, min, max: 30), the interval (4), the tests (14) and the
# running minimum (3); a medium the maps, slabs and interval, the world
# ray's quadratic and roots (27), its tests and clamps (17) and the
# running minimum
OPS_BOX = 84
OPS_MEDIUM = 114


class BoxMediaOperand(NamedTuple):
    boxes: Optional[Boxes]             # the scene's boxes (box scenes)
    media: Optional[Media]             # the scene's media (media scenes)
    box_rec: Optional[torch.Tensor]    # [n_boxes, BOX_W] f32
    media_rec: Optional[torch.Tensor]  # [n_media, MEDIA_W] f32


def pack_boxes(boxes: Boxes) -> torch.Tensor:
    """[N, BOX_W] records: obj_from_world's three rows, then p0 xyz, p1
    xyz, the mask as 1.0 / 0.0 and a 0 (the kernel's five float4 rows)."""
    n = boxes.count
    f = torch.float32
    return torch.cat([
        boxes.obj_from_world.detach().to(f).reshape(n, 12),
        boxes.p0.detach().to(f), boxes.p1.detach().to(f),
        boxes.mask.detach().to(f)[:, None],
        torch.zeros((n, 1), dtype=f, device=boxes.p0.device)],
        dim=1).contiguous()


def pack_media(media: Media) -> torch.Tensor:
    """[N, MEDIA_W] records: a box's fields with the kind (float) in the
    pad, then the radius and three 0s (six float4 rows)."""
    n = media.count
    f = torch.float32
    return torch.cat([
        media.obj_from_world.detach().to(f).reshape(n, 12),
        media.p0.detach().to(f), media.p1.detach().to(f),
        media.mask.detach().to(f)[:, None],
        media.kind.detach().to(f)[:, None],
        media.radius.detach().to(f)[:, None],
        torch.zeros((n, 3), dtype=f, device=media.p0.device)],
        dim=1).contiguous()


def pack_operand(boxes: Optional[Boxes],
                 media: Optional[Media]) -> Optional[BoxMediaOperand]:
    """The operand of these boxes and media (either may be None); None
    when there are neither."""
    if boxes is None and media is None:
        return None
    return BoxMediaOperand(
        boxes, media,
        pack_boxes(boxes) if boxes is not None else None,
        pack_media(media) if media is not None else None)


def box_media_operand(scene: Scene,
                      features: SceneFeatures) -> Optional[BoxMediaOperand]:
    """The operand of the kinds of ``scene`` that ``features`` finds
    (its boxes, its media); None in a scene with neither."""
    return pack_operand(scene.boxes if features.has_boxes else None,
                        scene.media if features.has_media else None)


def _uniform_rows(uniforms) -> torch.Tensor:
    """The media's uniforms, a list of [R] or [n_media, R], as
    [n_media, R]."""
    return (uniforms if torch.is_tensor(uniforms)
            else torch.stack(list(uniforms)))


def media_flights(density: torch.Tensor, uniforms) -> torch.Tensor:
    """[n_media, R] free flights ``-log(max(u, 1e-38)) / density`` of
    the media's uniforms (a list of [R], or [n_media, R]), the plain
    version's operations on the same elements (the whole-scene BVH's
    traversal reads them too)."""
    u = _uniform_rows(uniforms)
    return (-torch.log(torch.clamp(u, min=1e-38))
            / density.detach()[:, None]).contiguous()


Hit = Tuple[torch.Tensor, torch.Tensor]


def box_media_nearest(op: BoxMediaOperand, rays: torch.Tensor,
                      uniforms=None, t_min: float = MIN_T,
                      t_max: float = MAX_T
                      ) -> Tuple[Optional[Hit], Optional[Hit]]:
    """Each kind's closest hit for the rays [6, R]: ((t [R] f32, idx [R]
    int32) of the boxes or None, the same of the media or None).
    ``uniforms``: the media's free-flight uniforms (a list of [R], or
    [n_media, R]). A ray that hits nothing of a kind gets (MAX_T, 0)."""
    global PLAIN_CALLS
    if rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError(f"rays must be [6, R], got {tuple(rays.shape)}")
    if op.media is not None and uniforms is None:
        raise ValueError("a media scene needs the free-flight uniforms")
    if rays.device.type == "cpu":
        PLAIN_CALLS += 1
        with torch.no_grad():  # as the kernel: t carries no gradient
            box = (box_nearest_rn(op.boxes, *rays, t_min=t_min, t_max=t_max)
                   if op.boxes is not None else None)
            med = (media_nearest_rn(op.media, *rays, uniforms, t_min=t_min,
                                    t_max=t_max)
                   if op.media is not None else None)
        return box, med
    if rays.device.type != "cuda":
        raise ValueError(f"box_media_nearest: unsupported device "
                         f"{rays.device}")
    flights = (media_flights(op.media.density, uniforms)
               if op.media is not None else None)
    return _launch(op, rays, flights, t_min, t_max)


def _launch(op: BoxMediaOperand, rays: torch.Tensor,
            flights: Optional[torch.Tensor], t_min: float, t_max: float):
    global LAUNCHES
    from pathtrace_tpu_torch.ops import _cuda_build

    if rays.dtype != torch.float32 or rays.stride(1) != 1:
        rays = rays.to(torch.float32).contiguous()
    R, dev = rays.shape[1], rays.device
    for rec in (op.box_rec, op.media_rec):
        if rec is not None and (rec.device != dev or not rec.is_contiguous()
                                or rec.dtype != torch.float32):
            raise ValueError(f"records must be contiguous float32 on {dev}")
    n_b = op.box_rec.shape[0] if op.box_rec is not None else 0
    n_m = op.media_rec.shape[0] if op.media_rec is not None else 0
    if n_m and (flights is None or flights.shape != (n_m, R)
                or flights.device != dev or not flights.is_contiguous()):
        raise ValueError(f"a media scene needs flights [{n_m}, {R}]")

    def out():
        return (torch.empty(R, dtype=torch.float32, device=dev),
                torch.empty(R, dtype=torch.int32, device=dev))

    box = out() if n_b else None
    med = out() if n_m else None
    if R and (n_b or n_m):
        lib = _cuda_build.library()
        code = lib.pt_box_media_nearest(
            rays.data_ptr(), rays.stride(0), R,
            op.box_rec.data_ptr() if n_b else None, n_b,
            op.media_rec.data_ptr() if n_m else None, n_m,
            flights.data_ptr() if n_m else None,
            float(t_min), float(t_max),
            box[0].data_ptr() if n_b else None,
            box[1].data_ptr() if n_b else None,
            med[0].data_ptr() if n_m else None,
            med[1].data_ptr() if n_m else None,
            torch.cuda.current_stream(dev).cuda_stream)
        _cuda_build.check(code, "box_media_nearest launch")
        LAUNCHES += 1
    return box, med


# ---------------------------------------------------------------------------
# the winner's t, recomputed where autograd needs it
# ---------------------------------------------------------------------------

def box_winner_t(boxes: Boxes, idx: torch.Tensor, rox, roy, roz, rdx, rdy,
                 rdz, t_min: float = MIN_T, t_max: float = MAX_T):
    """The t [R] of each ray's box ``idx``: ``box_nearest_rn``'s
    candidate of that (ray, box) pair (``intersect_box.box_candidate`` on
    the box gathered at idx), so the winner's t bit for bit, with the
    [R, N] form's gradient."""
    i = idx.long()
    return box_candidate(boxes.p0[i], boxes.p1[i], boxes.obj_from_world[i],
                         boxes.mask[i], (rox, roy, roz), (rdx, rdy, rdz),
                         t_min, t_max)


def media_winner_t(media: Media, idx: torch.Tensor, rox, roy, roz, rdx, rdy,
                   rdz, uniforms, t_min: float = MIN_T,
                   t_max: float = MAX_T):
    """The t [R] of each ray's medium ``idx`` (``media_nearest_rn``'s
    candidate of that pair, ``intersect_box.media_candidate`` on the
    medium gathered at idx), at that medium's uniform."""
    i = idx.long()
    return media_candidate(
        media.p0[i], media.p1[i], media.obj_from_world[i],
        (media.radius * media.radius)[i], media.kind[i] == MEDIUM_SPHERE,
        media.mask[i], media.density[i], (rox, roy, roz), (rdx, rdy, rdz),
        _uniform_rows(uniforms).gather(0, i[None])[0], t_min, t_max)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in tensors)


def box_media_hits(op: BoxMediaOperand, ro: torch.Tensor, rd: torch.Tensor,
                   uniforms=None, t_min: float = MIN_T,
                   t_max: float = MAX_T):
    """:func:`box_media_nearest` of the rays (ro, rd [R, 3]), with each
    kind's t recomputed at its winner (:func:`box_winner_t`,
    :func:`media_winner_t`) where autograd needs it: the same bits, and
    the [R, N] form's gradient."""
    rays = torch.cat([ro.detach().T, rd.detach().T]).contiguous()
    box, med = box_media_nearest(op, rays, uniforms, t_min, t_max)
    planes = (*ro.unbind(1), *rd.unbind(1))
    if box is not None and _needs_grad(ro, rd, op.boxes.p0, op.boxes.p1,
                                       op.boxes.obj_from_world):
        box = (box_winner_t(op.boxes, box[1], *planes, t_min=t_min,
                            t_max=t_max), box[1])
    m = op.media
    if med is not None and _needs_grad(ro, rd, m.p0, m.p1, m.obj_from_world,
                                       m.radius, m.density):
        med = (media_winner_t(m, med[1], *planes, uniforms, t_min=t_min,
                              t_max=t_max), med[1])
    return box, med


def yardsticks(R: int, n_boxes: int, n_media: int) -> dict:
    """The least time the card could take for one sweep of ``R`` rays
    over ``n_boxes`` boxes and ``n_media`` media: the pairs' operations
    at one instruction each over the 33.5 T/s issue rate, against the
    bytes of the rays in (24 a ray), the flights in (4 a (ray, medium)),
    the records read once and each kind's (t, idx) out (8 a ray)."""
    from pathtrace_tpu_torch.tools._probe import HBM_BYTES_PER_S, ISSUE_PER_S

    ops = R * (OPS_BOX * n_boxes + OPS_MEDIUM * n_media)
    nbytes = (R * (24 + 4 * n_media + 8 * ((n_boxes > 0) + (n_media > 0)))
              + 4 * (BOX_W * n_boxes + MEDIA_W * n_media))
    ops_ms = ops / ISSUE_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "issue_ceiling_ms": ops_ms, "bytes_ms": bytes_ms,
            "operations": ops, "bytes": nbytes}
