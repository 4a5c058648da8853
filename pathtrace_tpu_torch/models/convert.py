"""Carry scene and camera state across from the JAX package.

The reference's ``Scene`` and ``Camera`` are trees of arrays. Flattened to
numpy under dotted keys (``"spheres.center"``, ``"materials.kind"``,
``"perlin.randvec"``, ``"atlas.data"``, ``"sky"``, ``"camera.origin"``,
...), they load here as the port's
dataclasses, on the card unless the caller names another device. Nothing here imports jax: the caller does the
flattening (``np.asarray`` per leaf), so a saved ``.npz`` works as well.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.models import types as T

_GROUPS = {"spheres": T.Spheres, "rects": T.Rects, "boxes": T.Boxes,
           "media": T.Media, "materials": T.Materials, "textures": T.Textures,
           "perlin": T.PerlinTables, "atlas": T.ImageAtlas}


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def scene_from_numpy(leaves: Mapping[str, np.ndarray], device="cuda") -> T.Scene:
    """Build the port's Scene from the reference's flattened leaves.
    Instanced spheres and rects carry their ``world_from_obj`` /
    ``obj_from_world`` leaves (both or neither). The atlas leaves may be
    left out of a scene without image textures (it then gets the
    placeholder), and the ``perlin.*`` leaves of a scene without noise
    textures (it then gets the builder's default tables); the reference's
    ``atlas.data_planes``, a transposed copy of ``atlas.data``, is not
    read."""
    for kind in ("spheres", "rects"):
        if ((f"{kind}.world_from_obj" in leaves)
                != (f"{kind}.obj_from_world" in leaves)):
            raise ValueError(f"{kind}: an instance needs both affines")
    groups = dict(_GROUPS)
    parts = {}
    if "atlas.data" not in leaves:
        if np.any(np.asarray(leaves["textures.kind"]) == T.TEX_IMAGE):
            raise ValueError("scene has image textures but no atlas leaves")
        del groups["atlas"]
        parts["atlas"] = T.ImageAtlas.placeholder().to(device)
    if "perlin.randvec" not in leaves:
        if np.any(np.asarray(leaves["textures.kind"]) == T.TEX_NOISE):
            raise ValueError("scene has noise textures but no perlin leaves")
        del groups["perlin"]
        parts["perlin"] = T.PerlinTables.default().to(device)
    parts.update({
        name: cls(**{f.name: _tensor(leaves[f"{name}.{f.name}"], device)
                     for f in dataclasses.fields(cls)
                     if f"{name}.{f.name}" in leaves
                     or f.default is dataclasses.MISSING})
        for name, cls in groups.items()
    })
    return T.Scene(
        **parts,
        sky=_tensor(np.asarray(leaves["sky"], np.float32), device),
        use_gradient_sky=_tensor(
            np.asarray(leaves["use_gradient_sky"], np.float32), device),
    )


def camera_from_numpy(leaves: Mapping[str, np.ndarray], device="cuda") -> Camera:
    """Build the port's Camera from ``camera.<field>`` leaves."""
    return Camera(**{
        f.name: _tensor(np.asarray(leaves[f"camera.{f.name}"], np.float32),
                        device)
        for f in dataclasses.fields(Camera)
    })


def scene_to_numpy(scene: T.Scene) -> dict:
    """The inverse of :func:`scene_from_numpy` (dotted keys, numpy leaves)."""
    out = {}
    for name in _GROUPS:
        for key, val in getattr(scene, name).numpy().items():
            out[f"{name}.{key}"] = val
    out["sky"] = scene.sky.cpu().numpy()
    out["use_gradient_sky"] = scene.use_gradient_sky.cpu().numpy()
    return out


def camera_to_numpy(camera: Camera) -> dict:
    return {f"camera.{f.name}": getattr(camera, f.name).cpu().numpy()
            for f in dataclasses.fields(Camera)}
