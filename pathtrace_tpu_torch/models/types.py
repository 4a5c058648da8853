"""Scene representation: dataclasses of tensors.

Counterpart of ``pathtrace_tpu/models/types.py`` for the sphere-only slice:
spheres, materials, textures and the sky. Rects, boxes, media and the image
atlas are not ported yet. Every leaf is a tensor; ``.to(device)`` moves a
whole dataclass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Material kinds (same codes as the JAX package).
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

# Texture kinds.
TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_NOISE = 2
TEX_IMAGE = 3


class _TensorData:
    """``.to(device)`` and ``numpy()`` over every dataclass field."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    def numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class Spheres(_TensorData):
    """SoA sphere array. ``radius`` is signed: negative flips the normal
    (hollow dielectric shells). Static spheres have zero ``center_delta``
    and ``inv_time_delta``."""

    center: torch.Tensor          # [N, 3] f32
    center_delta: torch.Tensor    # [N, 3] f32
    time0: torch.Tensor           # [N] f32
    inv_time_delta: torch.Tensor  # [N] f32
    radius: torch.Tensor          # [N] f32
    mat_id: torch.Tensor          # [N] i32
    mask: torch.Tensor            # [N] bool

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass
class Materials(_TensorData):
    kind: torch.Tensor     # [M] i32
    tex_id: torch.Tensor   # [M] i32
    fuzz: torch.Tensor     # [M] f32
    ref_idx: torch.Tensor  # [M] f32


@dataclasses.dataclass
class Textures(_TensorData):
    """Texture table; checker children are one level deep."""

    kind: torch.Tensor      # [T] i32
    color: torch.Tensor     # [T, 3] f32
    odd_id: torch.Tensor    # [T] i32
    even_id: torch.Tensor   # [T] i32
    scale: torch.Tensor     # [T] f32 noise scale
    image_id: torch.Tensor  # [T] i32 (always 0: no image textures yet)


@dataclasses.dataclass
class Scene:
    """``sky`` is the constant sky colour, used when ``use_gradient_sky``
    is 0; otherwise the gradient sky."""

    spheres: Spheres
    materials: Materials
    textures: Textures
    sky: torch.Tensor               # [3] f32
    use_gradient_sky: torch.Tensor  # [] f32, 1.0 or 0.0

    def to(self, device) -> "Scene":
        return Scene(
            spheres=self.spheres.to(device),
            materials=self.materials.to(device),
            textures=self.textures.to(device),
            sky=self.sky.to(device),
            use_gradient_sky=self.use_gradient_sky.to(device),
        )


class SceneFeatures:
    """Static scene capabilities, derived host-side (same slots as the JAX
    package's ``SceneFeatures``). Kinds this slice has no tables for are
    always False here; ``fastpath_supported`` refuses the rest."""

    __slots__ = (
        "has_spheres", "has_motion", "has_rects", "has_boxes", "has_media",
        "has_noise", "has_checker", "has_image",
        "has_lambertian", "has_metal", "has_dielectric", "has_light",
        "has_isotropic",
        "checker_depth", "checker_children_const",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            if k == "checker_depth":
                setattr(self, k, int(kw.get(k, 4)))
            else:
                setattr(self, k, bool(kw.get(k, True)))

    def _key(self):
        return tuple(getattr(self, k) for k in self.__slots__)

    def __repr__(self):
        on = [k for k in self.__slots__ if getattr(self, k)]
        return f"SceneFeatures({', '.join(on)})"

    @staticmethod
    def from_scene(scene: Scene) -> "SceneFeatures":
        kinds = scene.textures.kind.cpu().numpy()
        odd = scene.textures.odd_id.cpu().numpy()
        even = scene.textures.even_id.cpu().numpy()
        mat_kinds = set(scene.materials.kind.cpu().numpy().tolist())
        tex_kinds = set(kinds.tolist())

        def _chk_depth(i, seen):
            if kinds[i] != TEX_CHECKER or i in seen:
                return 0
            seen = seen | {i}
            return 1 + max(_chk_depth(odd[i], seen), _chk_depth(even[i], seen))

        checker_ids = np.nonzero(kinds == TEX_CHECKER)[0]
        checker_depth = max(
            (_chk_depth(int(i), frozenset()) for i in checker_ids), default=1
        )
        children_const = all(
            kinds[odd[i]] == TEX_CONSTANT and kinds[even[i]] == TEX_CONSTANT
            for i in checker_ids
        )
        sp = scene.spheres
        return SceneFeatures(
            checker_depth=max(checker_depth, 1),
            checker_children_const=children_const,
            has_spheres=bool(sp.mask.any()),
            has_motion=bool((sp.inv_time_delta != 0.0).any()),
            has_rects=False,
            has_boxes=False,
            has_media=False,
            has_noise=TEX_NOISE in tex_kinds,
            has_checker=TEX_CHECKER in tex_kinds,
            has_image=TEX_IMAGE in tex_kinds,
            has_lambertian=MAT_LAMBERTIAN in mat_kinds,
            has_metal=MAT_METAL in mat_kinds,
            has_dielectric=MAT_DIELECTRIC in mat_kinds,
            has_light=MAT_DIFFUSE_LIGHT in mat_kinds,
            has_isotropic=MAT_ISOTROPIC in mat_kinds,
        )
