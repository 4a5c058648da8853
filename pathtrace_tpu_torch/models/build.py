"""Host-side scene construction in numpy, emitting a tensor :class:`Scene`.

Counterpart of ``pathtrace_tpu/models/build.py`` for spheres, materials
and constant/checker/noise textures. ``finish`` pads the sphere array with
far-away, masked-off spheres and can Morton-sort it, exactly as the JAX
builder does, so a preset built here equals the reference leaf for leaf.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pathtrace_tpu_torch.models import types as T

Vec3 = Union[Tuple[float, float, float], Sequence[float], np.ndarray]


def _v3(v: Vec3) -> np.ndarray:
    return np.asarray(v, dtype=np.float32).reshape(3)


def _pad_to(n: int, multiple: int) -> int:
    """Pad counts to a static capacity (>= 1 entry)."""
    n = max(n, 1)
    return ((n + multiple - 1) // multiple) * multiple


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit quantized xyz columns into 30-bit Morton codes."""

    def spread(v: np.ndarray) -> np.ndarray:
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    return (
        spread(q[:, 0])
        | (spread(q[:, 1]) << np.uint64(1))
        | (spread(q[:, 2]) << np.uint64(2))
    )


class SceneBuilder:
    """Accumulates spheres, materials and textures, then emits a Scene."""

    def __init__(self):
        self._sph = []   # (center, radius, mat)
        self._mats = []  # (kind, tex, fuzz, ref_idx)
        self._texs = []  # (kind, color, odd, even, scale)
        self.sky: Optional[Vec3] = None  # None => gradient sky

    # ---- textures ----
    def constant_texture(self, color: Vec3) -> int:
        self._texs.append((T.TEX_CONSTANT, _v3(color), 0, 0, 0.0))
        return len(self._texs) - 1

    def checker_texture(self, odd_id: int, even_id: int) -> int:
        self._texs.append((T.TEX_CHECKER, np.zeros(3, np.float32), odd_id,
                           even_id, 0.0))
        return len(self._texs) - 1

    def noise_texture(self, scale: float) -> int:
        self._texs.append((T.TEX_NOISE, np.zeros(3, np.float32), 0, 0,
                           float(scale)))
        return len(self._texs) - 1

    # ---- materials ----
    def _mat(self, kind: int, tex_id: int, fuzz: float = 0.0,
             ref_idx: float = 1.0) -> int:
        self._mats.append((kind, tex_id, float(fuzz), float(ref_idx)))
        return len(self._mats) - 1

    def lambertian(self, tex_id: int) -> int:
        return self._mat(T.MAT_LAMBERTIAN, tex_id)

    def lambertian_color(self, color: Vec3) -> int:
        return self.lambertian(self.constant_texture(color))

    def metal(self, albedo: Vec3, fuzz: float) -> int:
        return self._mat(T.MAT_METAL, self.constant_texture(albedo), fuzz=fuzz)

    def dielectric(self, ref_idx: float) -> int:
        return self._mat(T.MAT_DIELECTRIC,
                         self.constant_texture((1.0, 1.0, 1.0)),
                         ref_idx=ref_idx)

    def diffuse_light(self, tex_id: int) -> int:
        return self._mat(T.MAT_DIFFUSE_LIGHT, tex_id)

    def diffuse_light_color(self, color: Vec3) -> int:
        return self.diffuse_light(self.constant_texture(color))

    # ---- primitives ----
    def sphere(self, center: Vec3, radius: float, mat_id: int) -> None:
        self._sph.append((_v3(center), float(radius), mat_id))

    # ---- finish ----
    def finish(self, pad_multiple: int = 1,
               spatial_sort: bool = False) -> T.Scene:
        """Pad the sphere array to a multiple of ``pad_multiple`` and emit
        the Scene as CPU tensors.

        ``spatial_sort`` orders spheres by the Morton code of their centres
        (the reference's layout for tile culling; winner selection is a min
        over t, so order changes no image except at exact ties)."""
        f32, i32 = np.float32, np.int32

        if spatial_sort and len(self._sph) > 2:
            centers = np.stack([c for (c, _r, _m) in self._sph])
            lo = centers.min(axis=0)
            ext = np.maximum(centers.max(axis=0) - lo, 1e-9)
            q = np.clip((centers - lo) / ext * 1023.0, 0.0, 1023.0)
            codes = _morton3(q.astype(np.uint32))
            order = np.argsort(codes, kind="stable")
            self._sph = [self._sph[i] for i in order]

        ns = _pad_to(len(self._sph), pad_multiple)
        # padding spheres sit at a huge far-away centre and are masked off
        sp_center = np.full((ns, 3), 1.0e18, f32)
        sp_radius = np.zeros(ns, f32)
        sp_mat = np.zeros(ns, i32)
        sp_mask = np.zeros(ns, bool)
        for i, (c, r, m) in enumerate(self._sph):
            sp_center[i] = c
            sp_radius[i] = r
            sp_mat[i] = m
            sp_mask[i] = True

        nmat = max(len(self._mats), 1)
        ma_kind = np.zeros(nmat, i32)
        ma_tex = np.zeros(nmat, i32)
        ma_fuzz = np.zeros(nmat, f32)
        ma_ref = np.ones(nmat, f32)
        for i, (kind, tex, fuzz, ref_idx) in enumerate(self._mats):
            ma_kind[i], ma_tex[i], ma_fuzz[i], ma_ref[i] = kind, tex, fuzz, ref_idx

        ntex = max(len(self._texs), 1)
        tx_kind = np.zeros(ntex, i32)
        tx_color = np.zeros((ntex, 3), f32)
        tx_odd = np.zeros(ntex, i32)
        tx_even = np.zeros(ntex, i32)
        tx_scale = np.zeros(ntex, f32)
        for i, (kind, color, odd, even, scale) in enumerate(self._texs):
            tx_kind[i] = kind
            tx_color[i] = color
            tx_odd[i], tx_even[i] = odd, even
            tx_scale[i] = scale

        t = torch.from_numpy
        sky = np.zeros(3, f32) if self.sky is None else _v3(self.sky)
        return T.Scene(
            spheres=T.Spheres(
                center=t(sp_center), center_delta=t(np.zeros((ns, 3), f32)),
                time0=t(np.zeros(ns, f32)), inv_time_delta=t(np.zeros(ns, f32)),
                radius=t(sp_radius), mat_id=t(sp_mat), mask=t(sp_mask),
            ),
            materials=T.Materials(t(ma_kind), t(ma_tex), t(ma_fuzz), t(ma_ref)),
            textures=T.Textures(t(tx_kind), t(tx_color), t(tx_odd), t(tx_even),
                                t(tx_scale), t(np.zeros(ntex, i32))),
            sky=t(sky),
            use_gradient_sky=torch.tensor(1.0 if self.sky is None else 0.0,
                                          dtype=torch.float32),
        )
