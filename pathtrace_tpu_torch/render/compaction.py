"""Stream-compacted general tracing: ``--mode compacted`` (counterpart of
``pathtrace_tpu/render/compaction.py``).

The general integrator under the host's compaction ladder. Each bounce
runs over the whole current wavefront, dead lanes masked
(``integrator._bounce``); then the host reads the alive count (one
readback a bounce), and when the alive lanes fit a power-of-two rung at
most half the current size it flushes the radiance into the full-size
output (by each slot's original ray) and gathers the alive lanes to the
front, in order, at the smaller size.

The bounce draws its uniforms over the current wavefront, as the
reference's does: ``uniform(fold_in(fold_in(key, depth), j), [size, ...])``,
so after a compaction a ray draws the uniforms of its new slot. That is
the reference's "modulo RNG slotting": the image differs from the
uncompacted integrator's by the random streams only, and equals the
reference's compacted image, which slots its rays the same way. Like the
reference's, the ladder runs neither NEE nor roulette.

``-B`` reaches this path in ``auto`` mode for a scene the fast path
refuses: ``intersect_fn`` is then the tree's
(``models.bvh.make_bvh_intersect_fn``), and every lane of the wavefront
pays a traversal, so dropping the dead ones matters most there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.render import integrator
from pathtrace_tpu_torch.render.compact_util import partition_order, rung
from pathtrace_tpu_torch.utils import threefry

READBACKS = 0  # alive-count readbacks (one a bounce)


def compact_state(out_radiance: torch.Tensor,
                  state: integrator.WavefrontState, indices: torch.Tensor,
                  next_size: int, identity: bool):
    """Flush the state's radiance into ``out_radiance`` [R0, 3] (a dense
    add before the first compaction, when ``indices`` is the identity),
    then gather the alive lanes to the front at ``next_size`` slots
    (stable; the tail holds dead lanes), their radiance restarting at 0."""
    rad = state.radiance
    out_radiance = (out_radiance + rad if identity
                    else out_radiance.index_add(0, indices, rad))
    order, _, _ = partition_order(state.alive)
    perm = order[:next_size]
    new = state._replace(
        ro=state.ro[perm], rd=state.rd[perm], time=state.time[perm],
        radiance=torch.zeros((next_size, 3), dtype=rad.dtype,
                             device=rad.device),
        throughput=state.throughput[perm], alive=state.alive[perm],
        emit_scale=state.emit_scale[perm])
    return out_radiance, new, indices[perm]


def trace_compacted(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                    time: torch.Tensor, key: torch.Tensor, max_depth: int,
                    features: Optional[SceneFeatures] = None,
                    intersect_fn=None,
                    min_size: int = 1 << 13) -> Tuple[torch.Tensor, int]:
    """Trace with host-driven stream compaction: (radiance [R, 3], ray
    count), the count a host int (the alive lanes summed over bounces).
    ``key``: the Threefry key of the bounces; ``intersect_fn``: the
    whole-scene closest hit (``-B``), else the per-kind sweep; rungs never
    go below ``min_size`` lanes."""
    global READBACKS
    features = features or SceneFeatures.from_scene(scene)
    tables = integrator.prep_tables(scene, features)
    R = ro.shape[0]
    out_radiance = torch.zeros((R, 3), dtype=ro.dtype, device=ro.device)
    indices = torch.arange(R, dtype=torch.int64, device=ro.device)
    identity = True  # a dense flush until the first compaction
    state = integrator._initial_state(ro, rd, time)
    size, ray_count, n_alive = R, 0, R
    with torch.no_grad():
        for _ in range(max_depth + 1):
            ray_count += n_alive
            state = integrator._bounce(scene, tables, state, key, max_depth,
                                       features, intersect_fn=intersect_fn)
            n_alive = int(state.alive.sum())  # the bounce's one readback
            READBACKS += 1
            if n_alive == 0:
                break
            next_size = rung(n_alive, min_size)
            if next_size <= size // 2:
                out_radiance, state, indices = compact_state(
                    out_radiance, state, indices, next_size, identity)
                size, identity = next_size, False
        rad = state.radiance
        out_radiance = (out_radiance + rad if identity
                        else out_radiance.index_add(0, indices, rad))
    return out_radiance, ray_count


def render_frame_compacted(scene: Scene, camera, width: int, height: int,
                           samples: int, max_depth: int, key: torch.Tensor,
                           features: Optional[SceneFeatures] = None,
                           intersect_fn=None, min_size: int = 1 << 13):
    """A whole frame through :func:`trace_compacted` on the scene's
    device: (image [H, W, 3], ray count). ``kray, ktrace = split(key)``:
    the primary rays (iid jitter) from ``kray``, the bounces keyed by
    ``ktrace``, as the reference keys them."""
    from pathtrace_tpu_torch.render.frame import generate_primary_rays

    kray, ktrace = threefry.split(key)
    ro, rd, t = generate_primary_rays(camera, width, height, samples, kray,
                                      device=scene.sky.device)
    R = height * width * samples
    radiance, ray_count = trace_compacted(
        scene, ro.reshape(R, 3), rd.reshape(R, 3), t.reshape(R), ktrace,
        max_depth, features=features, intersect_fn=intersect_fn,
        min_size=min_size)
    return radiance.reshape(height, width, samples, 3).mean(dim=2), ray_count
