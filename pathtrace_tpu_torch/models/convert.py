"""Carry scene and camera state across from the JAX package.

The reference's ``Scene`` and ``Camera`` are trees of arrays. Flattened to
numpy under dotted keys (``"spheres.center"``, ``"materials.kind"``,
``"sky"``, ``"camera.origin"``, ...), they load here as the port's
dataclasses on any device. Nothing here imports jax: the caller does the
flattening (``np.asarray`` per leaf), so a saved ``.npz`` works as well.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.models import types as T

_GROUPS = {"spheres": T.Spheres, "materials": T.Materials,
           "textures": T.Textures}
# primitive kinds the JAX scene carries and this slice has no tables for:
# a live entry in any of them is refused rather than silently dropped
_ABSENT_KINDS = ("rects", "boxes", "media")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def scene_from_numpy(leaves: Mapping[str, np.ndarray], device="cpu") -> T.Scene:
    """Build the port's Scene from the reference's flattened leaves."""
    for kind in _ABSENT_KINDS:
        mask = leaves.get(f"{kind}.mask")
        if mask is not None and np.any(mask):
            raise ValueError(f"scene has live {kind}: not in this port yet")
    tex_kind = np.asarray(leaves["textures.kind"])
    if np.any(tex_kind == T.TEX_IMAGE):
        raise ValueError("scene has image textures: not in this port yet")
    parts = {
        name: cls(**{f.name: _tensor(leaves[f"{name}.{f.name}"], device)
                     for f in dataclasses.fields(cls)})
        for name, cls in _GROUPS.items()
    }
    return T.Scene(
        **parts,
        sky=_tensor(np.asarray(leaves["sky"], np.float32), device),
        use_gradient_sky=_tensor(
            np.asarray(leaves["use_gradient_sky"], np.float32), device),
    )


def camera_from_numpy(leaves: Mapping[str, np.ndarray], device="cpu") -> Camera:
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
