"""The ray wavefront split across devices and processes (counterpart of
``pathtrace_tpu/parallel/mesh.py``).

The reference runs one program over a 1-D mesh of every visible device:
the flattened ray axis [H*W*S] is sharded, the scene replicated, and the
ray count's ``psum`` is the forward pass's only collective; in training
the ``shard_map`` transpose all-reduces the scene gradient. The port
keeps that model in PyTorch's idiom:

* a :class:`RenderMesh` is the ordered list of devices this process
  drives, one shard each, and the ``torch.distributed`` process group it
  belongs to, if any. A device may repeat ("virtual shards", as the
  reference's tests run 8 virtual CPU devices). Global shard ``s = rank *
  n_local + i``;
* every process holds the whole ray set (each draws it from the same
  key) and traces its own shards' slices; the count is summed across
  processes with ``all_reduce`` and the radiance gathered with
  ``all_gather``, so every rank holds the whole frame;
* the fast shards key the bounce RNG on global lane ids (``lane_offset =
  s * shard_R``), so a sharded fast trace is bit for bit the one-shard
  trace; the general shards key their bounces ``fold_in(key, s)``, as the
  reference's shard at mesh position ``s``.

Within a process autograd sums the shards' contributions to the
replicated leaves; across processes the trainer all-reduces the
trainable leaves' gradients once (:mod:`~pathtrace_tpu_torch.parallel.inverse`).
The gathered radiance of other ranks carries no gradient, so each rank's
backward reaches its own shards only and the sum is the whole gradient.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.utils import threefry

# torchrun's environment, which --distributed reads
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """The shards this process traces (``devices``, in order; a device
    may repeat) and the process group whose ranks hold the others
    (``None``: this process holds every shard)."""

    devices: Tuple[torch.device, ...]
    group: Optional[object] = None

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """Shards across every process (the reference's mesh size)."""
        return self.world * self.n_local

    @property
    def home(self) -> torch.device:
        """Where the rays, the whole radiance and the image live."""
        return self.devices[0]

    def shards(self) -> List[Tuple[int, torch.device]]:
        """(global shard index, device) of this process's shards."""
        return [(self.rank * self.n_local + i, d)
                for i, d in enumerate(self.devices)]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_render_mesh(devices: Optional[Sequence] = None) -> RenderMesh:
    """A mesh over ``devices`` (mirrors ``mesh.py:39-42``), in the world
    process group once one is joined. By default every visible card, or
    in a joined group (``--distributed``) this process's card
    (``cuda:LOCAL_RANK``, the current device). The CPU only when the
    caller names it: with no card, the default raises."""
    joined = dist.is_available() and dist.is_initialized()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_render_mesh: no CUDA device is "
                               "available; name the devices to render on "
                               "(e.g. devices=['cpu'])")
        devices = ([torch.cuda.current_device()] if joined
                   else range(torch.cuda.device_count()))
        devices = [torch.device("cuda", i) for i in devices]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("make_render_mesh: no devices")
    return RenderMesh(devices, dist.group.WORLD if joined else None)


def init_distributed(device="cuda") -> torch.device:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL on the card ``cuda:LOCAL_RANK``, which becomes
    the current device, or gloo when ``device`` is the CPU. Returns the
    process's device. Raises without that environment, without a card for
    a CUDA device, and when the group cannot be joined."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError("--distributed needs torchrun's environment "
                           f"(missing {', '.join(missing)})")
    rank, world, local = (int(os.environ[k])
                          for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    addr = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dev = torch.device(device)
    kw = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on cuda: CUDA is not available")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
        kw["device_id"] = dev
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=addr, rank=rank,
                            world_size=world, **kw)
    return dev


def all_reduce_grads(params, mesh: RenderMesh) -> None:
    """Sum each leaf's gradient over the mesh's processes (nothing without
    a process group): each rank's backward holds its own shards' share of
    the global loss's gradient, so the sum is the whole gradient."""
    if mesh.group is not None:
        for p in params:
            dist.all_reduce(p.grad, group=mesh.group)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def fold_seed(seed: int, ktrace: torch.Tensor) -> int:
    """The fast mode's host seed fold (``mesh.py:178-190``): the frame
    key's last word xor'd into the seed, as an int32."""
    kd = int(ktrace.reshape(-1)[-1])
    return int((np.uint32(seed) ^ np.uint32(kd)).astype(np.int32))


def trace_sharded(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                  time: torch.Tensor, key: Optional[torch.Tensor],
                  max_depth: int, mesh: RenderMesh,
                  features: Optional[SceneFeatures] = None,
                  differentiable: bool = False, mode: str = "general",
                  seed=0, alive_limit: Optional[int] = None, bvh=None,
                  bvh_offsets=None):
    """Trace a wavefront split over the mesh's shards (``mesh.py:49``).

    ``ro``, ``rd`` [R, 3] and ``time`` [R] are the whole wavefront, the
    same on every rank, with R a multiple of the mesh size; shard ``s``
    traces rays ``[s * R/n, (s + 1) * R/n)`` on its device. Returns
    (radiance [R, 3] on ``mesh.home``, the whole ray count [] int64),
    the same on every rank.

    ``mode="fast"``: each shard runs
    :func:`~pathtrace_tpu_torch.ops.fastpath.trace_fast_device`
    (:func:`~pathtrace_tpu_torch.ops.fastpath.trace_fast_diff` when
    ``differentiable``) with ``lane_offset = s * R/n``, the bounce
    ``seed`` and ``alive_limit`` (global lane ids born dead); ``key`` is
    unused. ``bvh``/``bvh_offsets`` make the tree the forward shards'
    closest hit (the differentiable trace refuses it, as the reference's
    asserts). ``mode="general"``: each shard runs the general
    integrator's ``trace`` (``trace_diff`` when differentiable) keyed
    ``fold_in(key, s)``."""
    from pathtrace_tpu_torch.ops import fastpath
    from pathtrace_tpu_torch.render import integrator

    if mode not in ("fast", "general"):
        raise ValueError(f"trace_sharded: unknown mode '{mode}'")
    features = features or SceneFeatures.from_scene(scene)
    n = mesh.size
    R = ro.shape[0]
    if R % n:
        raise ValueError(f"ray count {R} not divisible by mesh size {n}")
    shard_R = R // n
    home = mesh.home
    scenes = {}
    parts = []
    count = torch.zeros((), dtype=torch.int64, device=home)
    for s, dev in mesh.shards():
        if dev not in scenes:
            scenes[dev] = scene.to(dev)
        sc = scenes[dev]
        sl = slice(s * shard_R, (s + 1) * shard_R)
        ro_s, rd_s, t_s = (x[sl].to(dev) for x in (ro, rd, time))
        if mode == "fast":
            kw = dict(lane_offset=s * shard_R, alive_limit=alive_limit)
            if differentiable:
                rad, cnt = fastpath.trace_fast_diff(
                    sc, ro_s, rd_s, t_s, seed, max_depth, features, bvh=bvh,
                    **kw)
            else:
                rad, cnt = fastpath.trace_fast_device(
                    sc, ro_s, rd_s, t_s, seed, max_depth, features,
                    bvh=bvh, bvh_offsets=bvh_offsets, **kw)
        else:
            trace_fn = (integrator.trace_diff if differentiable
                        else integrator.trace)
            rad, cnt = trace_fn(sc, ro_s, rd_s, t_s,
                                threefry.fold_in(key, s), max_depth,
                                features=features)
        parts.append(rad.to(home))
        count = count + cnt.to(home)
    local = torch.cat(parts) if len(parts) > 1 else parts[0]
    if mesh.group is None:
        return local, count
    dist.all_reduce(count, group=mesh.group)
    gathered = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(gathered, local.detach().contiguous(), group=mesh.group)
    # this rank's rows keep their graph; the others' carry no gradient
    gathered[mesh.rank] = local
    return torch.cat(gathered), count


def trace_padded(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                 time: torch.Tensor, key: Optional[torch.Tensor],
                 max_depth: int, mesh: RenderMesh,
                 features: Optional[SceneFeatures] = None,
                 differentiable: bool = False, mode: str = "general",
                 seed=0, bvh=None, bvh_offsets=None):
    """:func:`trace_sharded` of any R rays: padded to a multiple of the
    mesh size, traced, and cut back to [R, 3] (``mesh.py:196-219``).
    Fast padding lanes are born dead by global lane id (``alive_limit =
    R``); general padding lanes get a NaN time and are born dead, or, when
    differentiable (NaNs would reach the gradients), are copies of the
    first rays, whose segments the count then includes (at most n - 1
    rays too many). The reference pads its fast shards to ``n * 1024``
    rays for its kernels' blocks; lanes are global, so the image and the
    count do not depend on the pad, and the port's kernels take any
    width."""
    R = ro.shape[0]
    Rp = pad_to_multiple(R, mesh.size)
    if Rp != R:
        pad = Rp - R
        reps = -(-pad // R)

        def tile(x):
            return torch.cat([x] + [x[:R]] * reps)[:Rp]

        ro, rd = tile(ro), tile(rd)
        if mode == "fast" or differentiable:
            time = tile(time)
        else:
            time = torch.cat([time, torch.full((pad,), float("nan"),
                                               dtype=time.dtype,
                                               device=time.device)])
    radiance, count = trace_sharded(
        scene, ro, rd, time, key, max_depth, mesh, features=features,
        differentiable=differentiable, mode=mode, seed=seed,
        alive_limit=R if mode == "fast" else None, bvh=bvh,
        bvh_offsets=bvh_offsets)
    return radiance[:R], count


def render_frame_sharded(scene: Scene, camera, width: int, height: int,
                         samples: int, max_depth: int, key: torch.Tensor,
                         mesh: RenderMesh,
                         features: Optional[SceneFeatures] = None,
                         differentiable: bool = False, mode: str = "general",
                         seed=0, bvh=None, bvh_offsets=None):
    """A whole frame with its [H*W*S] ray axis split over the mesh
    (``mesh.py:148``): ``kray, ktrace = split(key)``, the primary rays
    from ``kray`` on ``mesh.home``, :func:`trace_padded` (the general
    shards keyed ``fold_in(ktrace, s)``), each pixel's sample mean.
    Returns (image [H, W, 3], ray count [] int64).

    In fast mode a Python-int ``seed`` gets the frame key folded in
    (:func:`fold_seed`), so a caller that varies only ``key`` still
    varies the bounces; any other seed (the trainer's
    ``randint(fold_in(key, 7))``, a tensor, as the reference's traced
    seed) is used as it is."""
    from pathtrace_tpu_torch.render.frame import generate_primary_rays

    kray, ktrace = threefry.split(key)
    if mode == "fast" and isinstance(seed, int):
        seed = fold_seed(seed, ktrace)
    ro, rd, t = generate_primary_rays(camera, width, height, samples, kray,
                                      device=mesh.home)
    R = height * width * samples
    radiance, count = trace_padded(
        scene, ro.reshape(R, 3), rd.reshape(R, 3), t.reshape(R), ktrace,
        max_depth, mesh, features=features, differentiable=differentiable,
        mode=mode, seed=seed, bvh=bvh, bvh_offsets=bvh_offsets)
    return radiance.reshape(height, width, samples, 3).mean(dim=2), count
