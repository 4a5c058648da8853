"""Scene representation: dataclasses of tensors.

Counterpart of ``pathtrace_tpu/models/types.py`` for spheres, axis-aligned
rects, transformed boxes, constant-density media, materials, textures, the
Perlin tables, the image atlas and the sky. Spheres and rects may carry
per-primitive ``[N, 3, 4]`` affine pairs (the reference's generic
``Instance``): ``None`` for a scene without instances. Every other leaf is
a tensor; ``.to(device)`` moves a whole dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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

# Medium boundary kinds.
MEDIUM_BOX = 0
MEDIUM_SPHERE = 1


class _TensorData:
    """``.to(device)`` and ``numpy()`` over every dataclass field that is
    not None."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        })

    def numpy(self) -> dict:
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


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
    # instances: None, or [N, 3, 4] affine pairs; ``center`` and
    # ``radius`` are then in each sphere's object space
    world_from_obj: Optional[torch.Tensor] = None
    obj_from_world: Optional[torch.Tensor] = None

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @property
    def instanced(self) -> bool:
        return self.world_from_obj is not None


@dataclasses.dataclass
class Rects(_TensorData):
    """Axis-aligned rectangles. ``axis`` is the normal axis (0: YZ-rect,
    1: XZ, 2: XY); ``(a, b)`` are the two in-plane axes in ascending order
    (YZ: a = y, b = z; XZ: a = x, b = z; XY: a = x, b = y); ``k`` is the
    plane's offset along ``axis`` and ``flip`` the normal's sign (+1 or
    -1)."""

    axis: torch.Tensor    # [N] i32 in {0, 1, 2}
    a0: torch.Tensor      # [N] f32
    a1: torch.Tensor      # [N] f32
    b0: torch.Tensor      # [N] f32
    b1: torch.Tensor      # [N] f32
    k: torch.Tensor       # [N] f32
    flip: torch.Tensor    # [N] f32, +1.0 or -1.0
    mat_id: torch.Tensor  # [N] i32
    mask: torch.Tensor    # [N] bool
    # instances: None, or [N, 3, 4] affine pairs (the rect's plane and
    # bounds are then in its object space)
    world_from_obj: Optional[torch.Tensor] = None
    obj_from_world: Optional[torch.Tensor] = None

    @property
    def count(self) -> int:
        return self.axis.shape[0]

    @property
    def instanced(self) -> bool:
        return self.world_from_obj is not None


def _identity_affines(n: int) -> torch.Tensor:
    out = torch.zeros((n, 3, 4), dtype=torch.float32)
    out[:, :, :3] = torch.eye(3)
    return out


@dataclasses.dataclass
class Boxes(_TensorData):
    """Transformed axis-aligned boxes: an object-space AABB ``[p0, p1]``
    and its affine pair (the reference's Cuboid inside an Instance). The
    hit is a slab test in object space; the normal is the entry or exit
    face's, mapped back through ``world_from_obj``."""

    p0: torch.Tensor              # [N, 3] f32 object-space min corner
    p1: torch.Tensor              # [N, 3] f32 object-space max corner
    world_from_obj: torch.Tensor  # [N, 3, 4] f32 affine
    obj_from_world: torch.Tensor  # [N, 3, 4] f32 affine (its inverse)
    mat_id: torch.Tensor          # [N] i32
    mask: torch.Tensor            # [N] bool

    @property
    def count(self) -> int:
        return self.p0.shape[0]

    @staticmethod
    def empty() -> "Boxes":
        """One dead box, as the builder pads a scene without boxes."""
        return Boxes(
            p0=torch.full((1, 3), 1.0e18), p1=torch.full((1, 3), 1.0e18),
            world_from_obj=_identity_affines(1),
            obj_from_world=_identity_affines(1),
            mat_id=torch.zeros(1, dtype=torch.int32),
            mask=torch.zeros(1, dtype=torch.bool),
        )


@dataclasses.dataclass
class Media(_TensorData):
    """Constant-density participating media whose boundary is a
    transformed box or a sphere (``kind``). Free flight is
    ``-ln(U) / density`` inside the boundary interval; the phase function
    is the isotropic material ``mat_id``."""

    kind: torch.Tensor            # [N] i32, MEDIUM_BOX or MEDIUM_SPHERE
    p0: torch.Tensor              # [N, 3] f32 box min (sphere centre)
    p1: torch.Tensor              # [N, 3] f32 box max (unused for spheres)
    radius: torch.Tensor          # [N] f32 sphere radius (unused for boxes)
    world_from_obj: torch.Tensor  # [N, 3, 4] f32
    obj_from_world: torch.Tensor  # [N, 3, 4] f32
    density: torch.Tensor         # [N] f32
    mat_id: torch.Tensor          # [N] i32
    mask: torch.Tensor            # [N] bool

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    @staticmethod
    def empty() -> "Media":
        """One dead medium, as the builder pads a scene without media."""
        return Media(
            kind=torch.zeros(1, dtype=torch.int32),
            p0=torch.full((1, 3), 1.0e18), p1=torch.full((1, 3), 1.0e18),
            radius=torch.zeros(1), world_from_obj=_identity_affines(1),
            obj_from_world=_identity_affines(1), density=torch.ones(1),
            mat_id=torch.zeros(1, dtype=torch.int32),
            mask=torch.zeros(1, dtype=torch.bool),
        )


@dataclasses.dataclass
class Materials(_TensorData):
    kind: torch.Tensor     # [M] i32
    tex_id: torch.Tensor   # [M] i32
    fuzz: torch.Tensor     # [M] f32
    ref_idx: torch.Tensor  # [M] f32


@dataclasses.dataclass
class Textures(_TensorData):
    """Texture table. A checker's children (``odd_id``, ``even_id``) are
    textures of any kind, checkers included."""

    kind: torch.Tensor      # [T] i32
    color: torch.Tensor     # [T, 3] f32
    odd_id: torch.Tensor    # [T] i32
    even_id: torch.Tensor   # [T] i32
    scale: torch.Tensor     # [T] f32 noise scale
    image_id: torch.Tensor  # [T] i32 atlas entry of an image texture (else 0)


@dataclasses.dataclass
class PerlinTables(_TensorData):
    """Perlin gradient and permutation tables: 256 random unit gradients
    and three independent permutations of 0..255, hashed by xor. Noise is
    gathers from them, differentiable in ``randvec``."""

    randvec: torch.Tensor  # [256, 3] f32 unit vectors
    perm_x: torch.Tensor   # [256] i32
    perm_y: torch.Tensor   # [256] i32
    perm_z: torch.Tensor   # [256] i32

    @staticmethod
    def from_rng(rng: np.random.Generator) -> "PerlinTables":
        """The tables drawn as the reference draws them: 256 gradients
        uniform in the cube [-1, 1)^3, normalized in float32, then three
        Fisher-Yates shuffles whose index is ``int(rng.random() * (i +
        1))``, from i = 255 down to 0."""
        v = rng.random((256, 3), dtype=np.float32) * 2.0 - 1.0
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        perms = []
        for _ in range(3):
            p = np.arange(256, dtype=np.int32)
            for i in range(255, -1, -1):
                tgt = int(rng.random() * (i + 1))
                p[i], p[tgt] = p[tgt], p[i]
            perms.append(torch.from_numpy(p))
        return PerlinTables(torch.from_numpy(v.astype(np.float32)), *perms)

    @staticmethod
    def default() -> "PerlinTables":
        """The builder's tables when no generator is given (seed 0)."""
        return PerlinTables.from_rng(np.random.default_rng(0))


@dataclasses.dataclass
class ImageAtlas(_TensorData):
    """Every image texture of a scene in one array: the images stacked
    vertically, left-aligned, with each one's (y_offset, height, width),
    so a texel lookup is one clamped read. A scene without images holds
    the builder's 1x1 black placeholder (0, 1, 1)."""

    data: torch.Tensor      # [H, W, 3] f32
    y_offset: torch.Tensor  # [I] i32
    height: torch.Tensor    # [I] i32
    width: torch.Tensor     # [I] i32

    @staticmethod
    def placeholder() -> "ImageAtlas":
        return ImageAtlas(
            data=torch.zeros((1, 1, 3), dtype=torch.float32),
            y_offset=torch.zeros(1, dtype=torch.int32),
            height=torch.ones(1, dtype=torch.int32),
            width=torch.ones(1, dtype=torch.int32),
        )


@dataclasses.dataclass
class Scene:
    """``sky`` is the constant sky colour, used when ``use_gradient_sky``
    is 0; otherwise the gradient sky. A scene built without boxes or media
    holds one dead entry of each, as the builder pads them, one without
    images the placeholder atlas, and one without Perlin tables the
    builder's default ones."""

    spheres: Spheres
    rects: Rects
    materials: Materials
    textures: Textures
    sky: torch.Tensor               # [3] f32
    use_gradient_sky: torch.Tensor  # [] f32, 1.0 or 0.0
    boxes: Boxes = dataclasses.field(default_factory=Boxes.empty)
    media: Media = dataclasses.field(default_factory=Media.empty)
    atlas: ImageAtlas = dataclasses.field(
        default_factory=ImageAtlas.placeholder)
    perlin: PerlinTables = dataclasses.field(
        default_factory=PerlinTables.default)

    def to(self, device) -> "Scene":
        return Scene(
            spheres=self.spheres.to(device),
            rects=self.rects.to(device),
            materials=self.materials.to(device),
            textures=self.textures.to(device),
            sky=self.sky.to(device),
            use_gradient_sky=self.use_gradient_sky.to(device),
            boxes=self.boxes.to(device),
            media=self.media.to(device),
            atlas=self.atlas.to(device),
            perlin=self.perlin.to(device),
        )


class SceneFeatures:
    """Static scene capabilities, derived host-side (same slots as the JAX
    package's ``SceneFeatures``); ``fastpath_supported`` and
    ``megakernel_supported`` refuse what their paths cannot render.
    ``checker_depth`` is the deepest nesting of checkers (a checker of a
    checker is 2), the levels the texture evaluation unrolls;
    ``checker_children_const`` holds when every checker's children are
    constants."""

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
            has_rects=bool(scene.rects.mask.any()),
            has_boxes=bool(scene.boxes.mask.any()),
            has_media=bool(scene.media.mask.any()),
            has_noise=TEX_NOISE in tex_kinds,
            has_checker=TEX_CHECKER in tex_kinds,
            has_image=TEX_IMAGE in tex_kinds,
            has_lambertian=MAT_LAMBERTIAN in mat_kinds,
            has_metal=MAT_METAL in mat_kinds,
            has_dielectric=MAT_DIELECTRIC in mat_kinds,
            has_light=MAT_DIFFUSE_LIGHT in mat_kinds,
            has_isotropic=MAT_ISOTROPIC in mat_kinds,
        )
