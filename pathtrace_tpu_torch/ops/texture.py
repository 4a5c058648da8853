"""Texture table evaluation (counterpart of ``pathtrace_tpu/ops/texture.py``),
the general integrator's textures.

Every kind is computed for the batch and combined with masked selects:
a constant colour, the marble noise ``0.5 (1 + sin(scale p.z + 10
turb(p)))``, and the nearest texel of an image (v flipped, both indices
clamped into the image). A checker picks its odd child where
``sin(10 x) sin(10 y) sin(10 z) < 0``, else its even child, and the
children are textures of any kind: the recursion is unrolled to
``SceneFeatures.checker_depth`` levels (any depth at least the scene's
nesting gives the same result). The turbulence and the checker's sines
depend on the point alone, so each is computed once for every level.
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.models.types import (
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    ImageAtlas,
    Scene,
    SceneFeatures,
    Textures,
)
from pathtrace_tpu_torch.ops import perlin


def _image_value(atlas: ImageAtlas, image_id: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Nearest texel with the v flip: column ``int(u w)``, row ``int((1 -
    v) h - 0.001)`` (truncated toward zero), each clamped into the
    image."""
    image_id = image_id.long()
    width = atlas.width[image_id].long()
    height = atlas.height[image_id].long()
    i = (u * width.to(torch.float32)).to(torch.int32).long()
    j = ((1.0 - v) * height.to(torch.float32) - 0.001).to(torch.int32).long()
    i = torch.minimum(torch.clamp(i, min=0), width - 1)
    j = torch.minimum(torch.clamp(j, min=0), height - 1)
    return atlas.data[atlas.y_offset[image_id].long() + j, i]


def _base_value(scene: Scene, tex_id: torch.Tensor, u, v, p, turb_val,
                f: SceneFeatures) -> torch.Tensor:
    """The non-checker kinds of the textures ``tex_id``: [..., 3]."""
    tex = scene.textures
    kind = tex.kind[tex_id]
    out = tex.color[tex_id]
    if f.has_noise:
        scale = tex.scale[tex_id]
        val = 0.5 * (1.0 + torch.sin(scale * p[..., 2] + 10.0 * turb_val))
        out = torch.where((kind == TEX_NOISE)[..., None],
                          val[..., None].expand(out.shape), out)
    if f.has_image:
        img = _image_value(scene.atlas, tex.image_id[tex_id], u, v)
        out = torch.where((kind == TEX_IMAGE)[..., None], img, out)
    return out


def _value_rec(scene: Scene, tex_id, u, v, p, turb_val, sines_neg,
               f: SceneFeatures, depth: int) -> torch.Tensor:
    """The textures ``tex_id`` with ``depth`` checker levels left to
    resolve (at 0 a node evaluates as its base kind)."""
    base = _base_value(scene, tex_id, u, v, p, turb_val, f)
    if not f.has_checker or depth <= 0:
        return base
    tex: Textures = scene.textures
    odd = _value_rec(scene, tex.odd_id[tex_id].long(), u, v, p, turb_val,
                     sines_neg, f, depth - 1)
    even = _value_rec(scene, tex.even_id[tex_id].long(), u, v, p, turb_val,
                      sines_neg, f, depth - 1)
    checker = torch.where(sines_neg[..., None], odd, even)
    return torch.where((tex.kind[tex_id] == TEX_CHECKER)[..., None], checker,
                       base)


def texture_value(scene: Scene, tex_id: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor, p: torch.Tensor,
                  features: SceneFeatures) -> torch.Tensor:
    """RGB [..., 3] of the textures ``tex_id`` [...] at (u, v) [...] and
    the points ``p`` [..., 3]. ``features`` leaves out the kinds the scene
    lacks."""
    f = features
    tex_id = tex_id.long()
    turb_val = perlin.turb(scene.perlin, p) if f.has_noise else None
    if not f.has_checker:
        return _base_value(scene, tex_id, u, v, p, turb_val, f)
    s = 10.0 * p
    sines_neg = (torch.sin(s[..., 0]) * torch.sin(s[..., 1])
                 * torch.sin(s[..., 2])) < 0.0
    return _value_rec(scene, tex_id, u, v, p, turb_val, sines_neg, f,
                      f.checker_depth)
