"""Progressive render loop (counterpart of
``pathtrace_tpu/render/progressive.py``), routed as the reference routes
it.

Each frame renders ``params.samples`` spp and blends into the running
average with ``mix_prev = n/(n+1)``. Frame ``n`` draws from
``fold_in(PRNGKey(seed), n)``. ``mode`` picks the path:

* ``"auto"``: the fast path (:func:`~pathtrace_tpu_torch.ops.fastpath.render_frame_fast`,
  bounce seed ``seed * 1000003 + n``, as the reference's fast mode) when
  it takes the scene, else the general integrator
  (:func:`~pathtrace_tpu_torch.render.frame.render_frame`): more than 128
  rects, instanced spheres or rects, checkers with non-constant
  children (the reference's own fallbacks). An image texture in a scene
  with boxes or media (``final_full``) takes the fast path's non-fused
  bounce, as in the reference;
* ``"fast"`` and ``"general"`` force their path (``"fast"`` raises for a
  scene it cannot take);
* ``"compacted"``: the general integrator under the host's compaction
  ladder (:func:`~pathtrace_tpu_torch.render.compaction.render_frame_compacted`,
  without NEE or roulette, as the reference's);
* ``"sharded"``: the frame's ray axis split over a render mesh
  (:func:`~pathtrace_tpu_torch.parallel.mesh.render_frame_sharded`; by
  default every visible card, or this process's card under
  ``--distributed``), as the reference's sharded branch
  (``progressive.py:124-137, 150-154, 187-214``): fast shards
  (``trace_fast_device``, bounce seed ``seed * 1000003 + n`` with the
  frame key folded in) when the fused bounce takes the scene
  (``fastpath.fused_refusal``: not an image texture in a scene with
  boxes or media, as the reference's ``fused_shade_supported`` gate),
  else general shards. ``-B``'s tree is the fast shards' closest hit; general shards
  drop it, and ``--nee``, ``--rr`` and ``--stratify`` are ignored, each
  with a log line. Every rank holds the whole image; rank 0 alone writes
  checkpoints and snapshots.

``Params.use_bvh`` (``-B``) builds the whole-scene BVH once
(``models.bvh.build_scene_bvh``, native SAH) and logs its census. Its
traversal then is the closest hit: the fast path's for a scene the fast
path takes (``final_full`` included: its non-fused bounce takes the tree
as its provider), else the general integrator's ``intersect_fn``, under
the compaction ladder in ``auto`` (the reference's route: a fast-path
scene, or ``compacted``), or plain ``render_frame`` with ``--mode
general``.

So a frame's image is the reference's up to the closest hit's rounding.
On CUDA each frame is timed with CUDA events around its work; the ray
count is read back once per frame, after the frame's last kernel.
``nee`` builds the scene's light table once and renders with next-event
estimation; a scene without lights renders with the plain estimator, as
the reference's does. A checkpoint resumes and saves the accumulation as
the reference's loop does (``progressive.py:247-252, 307-320``).

The loop's hooks are the reference's (``progressive.py:45-66,
256-316``): a rolling Mrays/s line every 10 frames
(:class:`~pathtrace_tpu_torch.utils.profiling.RollingMraysMeter`),
``on_frame(frame, acc)`` after each frame, and the live preview
(``preview``: :class:`~pathtrace_tpu_torch.render.preview.PreviewServer`
on ``preview_port``, fed the accumulation by reference). ``group`` and
``compaction`` are the fast path's knobs (bounces between alive-count
readbacks; the compaction ladder on or off); neither changes an image
bit. ``max_frames=None`` renders until Ctrl-C and returns the frames
done.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import Params
from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.ops.fastpath import (
    fastpath_refusal,
    fastpath_supported,
    fused_refusal,
    render_frame_fast,
)
from pathtrace_tpu_torch.ops.lights import build_light_table
from pathtrace_tpu_torch.render import compaction as pcompact
from pathtrace_tpu_torch.render import film, integrator
from pathtrace_tpu_torch.render.frame import accumulate, render_frame
from pathtrace_tpu_torch.utils import checkpoint as ckpt
from pathtrace_tpu_torch.utils import threefry
from pathtrace_tpu_torch.utils.profiling import RollingMraysMeter

MODES = ("auto", "fast", "general", "compacted", "sharded")


@dataclasses.dataclass
class ProgressiveResult:
    image: np.ndarray        # [H, W, 3] linear accumulated
    frames: int
    total_rays: int          # segments traced, all frames
    frame_ms: List[float]    # per frame: CUDA-event time (host clock on CPU)
    readbacks: List[int]     # per frame: alive-count readbacks (host syncs)
    timer: str               # "cuda-events" or "host-clock"
    path: str = ""           # the path that ran: "fast", "general",
    #                          "compacted", "sharded"


def route(scene: Scene, features: SceneFeatures, mode: str = "auto",
          use_bvh: bool = False) -> str:
    """The path ``mode`` takes for ``scene``: "fast", "general",
    "compacted" or "sharded". ``auto`` takes the fast path where it can;
    elsewhere the general integrator, under the compaction ladder with
    ``use_bvh``, as the reference routes ``-B``. Raises ``ValueError`` for
    an unknown mode, and for ``"fast"`` on a scene the fast path cannot
    take."""
    if mode not in MODES:
        raise ValueError(f"unknown mode '{mode}' (one of {', '.join(MODES)})")
    if mode in ("general", "compacted", "sharded"):
        return mode
    if mode == "fast":
        fastpath_supported(features, scene)
        return "fast"
    if fastpath_refusal(features, scene) is None:
        return "fast"
    return "compacted" if use_bvh else "general"


def save_image(path: str, image) -> None:
    """Write ``image`` [H, W, 3] linear to ``path``: a ``.npy`` as is, any
    other name as an sRGB PNG (flipped like the reference's)."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    if path.endswith(".npy"):
        np.save(path, image)
    else:
        film.save_frame_png(path, image)


def render_progressive(scene: Scene, camera: Camera, params: Params,
                       max_frames: Optional[int], device,
                       features: Optional[SceneFeatures] = None,
                       log: Callable[[str], None] = print, nee: bool = False,
                       rr_start: int = 0, stratify: bool = False,
                       mode: str = "auto",
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 50,
                       snapshot_path: Optional[str] = None,
                       snapshot_every: int = 0,
                       bvh=None, mesh=None, group: Optional[int] = None,
                       compaction: bool = True,
                       on_frame: Optional[Callable] = None,
                       preview: bool = False,
                       preview_port: int = 0) -> ProgressiveResult:
    """Render ``max_frames`` accumulated frames on ``device`` by the path
    ``mode`` routes to (:func:`route`); ``nee``: next-event estimation;
    ``rr_start`` > 0: Russian roulette from that depth; ``stratify``:
    Latin-hypercube samples in each pixel (the compacted path draws iid
    samples and runs neither NEE nor roulette, as the reference's).
    ``params.use_bvh`` (``-B``): render through the whole-scene BVH,
    built here unless ``bvh`` gives it (``build_scene_bvh``'s (flat,
    stats, offsets), which also turns it on). ``mesh``: the sharded
    path's render mesh (default: ``make_render_mesh()`` for a ``cuda``
    device without an index, else ``device`` alone; its process group
    when one is joined).

    ``checkpoint_path``: resume from it when it holds this seed's render
    at this film size (frames ``n..n + max_frames - 1`` follow its ``n``
    frames), save to it every ``checkpoint_every`` frames and at the end
    (:mod:`~pathtrace_tpu_torch.utils.checkpoint`), as the reference's
    loop does, so ``-F 2`` twice equals ``-F 4`` bit for bit.
    ``snapshot_path``: write the accumulated image there every
    ``snapshot_every`` frames (:func:`save_image`).

    ``group``, ``compaction``: the fast path's bounces between alive-count
    readbacks and its compaction ladder (the other paths ignore them).
    ``on_frame(frame, acc)``: called after each frame with the frames
    done and the accumulation (a tensor on the device). ``preview``: serve
    the accumulation live on ``preview_port`` (0: an ephemeral port).
    ``max_frames=None``: render until the caller stops the loop (a
    ``KeyboardInterrupt`` propagates, as the reference's; the CLI's
    interactive mode catches it and writes the frames done)."""
    device = torch.device(device)
    seed = params.resolve_seed()
    features = features or SceneFeatures.from_scene(scene)
    nee_lights = build_light_table(scene) if nee else None
    use_bvh = params.use_bvh or bvh is not None
    flat = offsets = intersect_fn = None
    if use_bvh:
        from pathtrace_tpu_torch.models import bvh as pbvh

        flat, stats, offsets = bvh or pbvh.build_scene_bvh(scene, seed=seed)
        log(f"bvh stats: {stats} ({flat.builder} build)")
    path = route(scene, features, mode, use_bvh)
    shard_fast = path == "sharded" and fused_refusal(features,
                                                     scene) is None
    if use_bvh and path not in ("fast", "sharded"):
        intersect_fn = pbvh.make_bvh_intersect_fn(flat, offsets, features)
    if use_bvh and path == "sharded" and not shard_fast:
        log("bvh: sharded mode has no general-path BVH provider; "
            "rendering sharded WITHOUT the tree")
        flat = offsets = None
    if path == "compacted" and (nee_lights is not None or rr_start
                                or stratify):
        log("nee, rr, stratify: ignored on the compacted path (as in the "
            "reference)")
    writer = True
    if path == "sharded":
        from pathtrace_tpu_torch.parallel import mesh as pmesh

        if nee_lights is not None:
            log("nee: ignored in --mode sharded (fast/general feature)")
            nee_lights = None
        if rr_start or stratify:
            log("rr, stratify: ignored in --mode sharded (as in the "
                "reference)")
        if mesh is None:
            mesh = pmesh.make_render_mesh(
                None if device == torch.device("cuda") else [device])
        device = mesh.home
        writer = mesh.rank == 0
        log(f"mesh: {mesh.size} shard(s) ({mesh.world} process(es) x "
            f"{mesh.n_local}: {', '.join(map(str, mesh.devices))}), "
            f"{'fast' if shard_fast else 'general'} shards")
    scene = scene.to(device)
    camera = camera.to(device)
    base_key = threefry.PRNGKey(seed)
    on_cuda = device.type == "cuda"

    acc = None
    start_frame = 0
    resumed = ckpt.try_load(checkpoint_path)
    if resumed is not None:
        acc_np, saved_frame, saved_seed = resumed
        if (saved_seed == seed
                and acc_np.shape == (params.height, params.width, 3)):
            acc = torch.from_numpy(acc_np).to(device)
            start_frame = saved_frame
            log(f"resumed from {checkpoint_path} at frame {start_frame}")

    def render_one(frame: int, acc):
        """Frame ``frame`` by ``path``, blended into ``acc``: (acc, ms,
        rays, readbacks). Timed with CUDA events around its work on the
        card (the host clock on the CPU); the ray count is read back once,
        after the frame's last kernel."""
        if on_cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        else:
            t0 = time.perf_counter()
        key = threefry.fold_in(base_key, frame)
        if path == "fast":
            res = render_frame_fast(
                scene, camera, params.width, params.height, params.samples,
                params.max_depth, key, seed * 1000003 + frame, features,
                nee_lights=nee_lights, rr_start=rr_start, stratify=stratify,
                bvh=flat, bvh_offsets=offsets, group=group,
                compaction=compaction,
            )
            image, count, n_read = res.image, res.ray_count, res.readbacks
        elif path == "sharded":
            before = integrator.READBACKS
            image, count = pmesh.render_frame_sharded(
                scene, camera, params.width, params.height, params.samples,
                params.max_depth, key, mesh, features=features,
                mode="fast" if shard_fast else "general",
                seed=seed * 1000003 + frame, bvh=flat, bvh_offsets=offsets,
            )
            n_read = integrator.READBACKS - before
        elif path == "compacted":
            before = pcompact.READBACKS
            image, count = pcompact.render_frame_compacted(
                scene, camera, params.width, params.height, params.samples,
                params.max_depth, key, features=features,
                intersect_fn=intersect_fn,
            )
            n_read = pcompact.READBACKS - before
        else:
            before = integrator.READBACKS
            image, count = render_frame(
                scene, camera, params.width, params.height, params.samples,
                params.max_depth, key, features=features, stratify=stratify,
                nee_lights=nee_lights, rr_start=rr_start,
                intersect_fn=intersect_fn,
            )
            n_read = integrator.READBACKS - before
        acc = image if acc is None else accumulate(acc, image, frame)
        if on_cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        return acc, ms, int(count), n_read

    preview_server = None
    if preview and writer:
        from pathtrace_tpu_torch.render.preview import PreviewServer

        preview_server = PreviewServer(port=preview_port)
        log(f"live preview at {preview_server.url}")
    meter = RollingMraysMeter()
    total_rays = 0
    frame_ms, readbacks = [], []
    frames = (range(start_frame, start_frame + max_frames)
              if max_frames is not None else itertools.count(start_frame))
    end = None if max_frames is None else start_frame + max_frames
    done = start_frame
    t_start = time.monotonic()
    try:
        for frame in frames:
            acc, ms, rays, n_read = render_one(frame, acc)
            total_rays += rays
            frame_ms.append(ms)
            readbacks.append(n_read)
            log(f"frame {frame + 1}/{end if end is not None else '-'}: "
                f"{ms:.2f} ms, {rays} rays, "
                f"{rays / 1e3 / max(ms, 1e-9):.2f} Mrays/s, "
                f"{n_read} readbacks ({path} path, "
                f"{'bvh' if flat is not None else 'sweep'})")
            line = meter.add_frame(rays)
            if line:
                log(line)
            done = frame + 1
            if preview_server is not None:
                rate = total_rays / 1e6 / max(time.monotonic() - t_start,
                                              1e-9)
                preview_server.update(acc, done, rate)
            if on_frame is not None:
                on_frame(done, acc)
            if writer and checkpoint_path and done % checkpoint_every == 0:
                ckpt.save(checkpoint_path, acc, done, seed)
            if (writer and snapshot_path and snapshot_every
                    and done % snapshot_every == 0):
                save_image(snapshot_path, acc)
    finally:
        if preview_server is not None:
            preview_server.close()
    image = (acc.cpu().numpy() if acc is not None else
             np.zeros((params.height, params.width, 3), np.float32))
    if writer and checkpoint_path:
        ckpt.save(checkpoint_path, image, done, seed)
    return ProgressiveResult(
        image=image, frames=done - start_frame, total_rays=total_rays,
        frame_ms=frame_ms, readbacks=readbacks,
        timer="cuda-events" if on_cuda else "host-clock", path=path,
    )
