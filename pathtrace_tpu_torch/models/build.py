"""Host-side scene construction in numpy, emitting a tensor :class:`Scene`.

Counterpart of ``pathtrace_tpu/models/build.py`` for spheres (static and
moving), axis-aligned rects, transformed boxes, constant-density media
(box or sphere boundary, isotropic phase function), materials,
constant/checker/noise/image textures, the Perlin tables and the affine
helpers. Spheres and rects take an optional ``transform`` (a 3x4
world-from-object affine, the reference's generic ``Instance``).
``finish`` pads the sphere array with far-away, masked-off spheres and can
Morton-sort it by the mid-shutter centres, pads the rects with masked-off
ones on a far plane and the boxes and media with masked-off ones at 1e18,
exactly as the JAX builder does, packs the images into one atlas and
draws the Perlin tables from the builder's generator, so a preset built
here equals the reference leaf for leaf.
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


def make_perlin_tables(rng: np.random.Generator) -> T.PerlinTables:
    """The Perlin tables drawn from ``rng`` as the reference draws them:
    256 normalized gradients uniform in the cube, then three Fisher-Yates
    permutations with a float-derived index."""
    return T.PerlinTables.from_rng(rng)


def identity_affine() -> np.ndarray:
    return np.concatenate(
        [np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)], axis=1
    )


def affine_from_rotation_y_translation(degrees: float,
                                       translation: Vec3) -> np.ndarray:
    """3x4 affine: rotate about +Y, then translate."""
    th = np.deg2rad(degrees)
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                   dtype=np.float32)
    m = np.zeros((3, 4), dtype=np.float32)
    m[:, :3] = rot
    m[:, 3] = _v3(translation)
    return m


def affine_from_axis_angle(axis: Vec3, degrees: float,
                           translation: Vec3 = (0.0, 0.0, 0.0),
                           scale: float = 1.0) -> np.ndarray:
    """3x4 affine: uniform scale, rotate about an arbitrary axis (computed
    in float64, rounded once), translate."""
    a = _v3(axis).astype(np.float64)
    a = a / np.linalg.norm(a)
    th = np.deg2rad(degrees)
    c, s = np.cos(th), np.sin(th)
    x, y, z = a
    rot = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = (rot * scale).astype(np.float32)
    m[:, 3] = _v3(translation)
    return m


def affine_compose(*ms: np.ndarray) -> np.ndarray:
    """Compose 3x4 affines in application order (``affine_compose(a, b)``
    applies ``a`` first), in float64, rounded once."""
    out = identity_affine().astype(np.float64)
    for m in ms:
        m = np.asarray(m, np.float64)
        lin = m[:, :3] @ out[:, :3]
        t = m[:, :3] @ out[:, 3] + m[:, 3]
        out = np.concatenate([lin, t[:, None]], axis=1)
    return out.astype(np.float32)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """Invert a 3x4 affine (invertible linear part): ``np.linalg.inv``,
    rounded once to float32."""
    lin = m[:, :3]
    t = m[:, 3]
    inv_lin = np.linalg.inv(lin)
    out = np.zeros((3, 4), dtype=np.float32)
    out[:, :3] = inv_lin
    out[:, 3] = -inv_lin @ t
    return out


def _opt_affine(m) -> Optional[np.ndarray]:
    if m is None:
        return None
    m = np.asarray(m, np.float32)
    if m.shape != (3, 4):
        raise ValueError(f"transform must be a 3x4 affine, got {m.shape}")
    return m


class SceneBuilder:
    """Accumulates spheres, rects, boxes, media, materials and textures,
    then emits a Scene. ``perlin_rng`` draws the Perlin tables at
    ``finish`` (default: a generator of seed 0, as the reference's)."""

    def __init__(self, perlin_rng: Optional[np.random.Generator] = None):
        # (center, delta, time0, inv_dt, radius, mat, transform)
        self._sph = []
        # (axis, a0, a1, b0, b1, k, flip, mat, transform)
        self._rects = []
        self._boxes = []  # (p0, p1, world_from_obj, mat)
        self._media = []  # (kind, p0, p1, radius, world_from_obj, density, mat)
        self._mats = []  # (kind, tex, fuzz, ref_idx)
        self._texs = []  # (kind, color, odd, even, scale, image)
        self._images = []  # [h, w, 3] f32 arrays
        self.sky: Optional[Vec3] = None  # None => gradient sky
        self._perlin_rng = perlin_rng or np.random.default_rng(0)

    # ---- textures ----
    def constant_texture(self, color: Vec3) -> int:
        self._texs.append((T.TEX_CONSTANT, _v3(color), 0, 0, 0.0, 0))
        return len(self._texs) - 1

    def checker_texture(self, odd_id: int, even_id: int) -> int:
        self._texs.append((T.TEX_CHECKER, np.zeros(3, np.float32), odd_id,
                           even_id, 0.0, 0))
        return len(self._texs) - 1

    def noise_texture(self, scale: float) -> int:
        self._texs.append((T.TEX_NOISE, np.zeros(3, np.float32), 0, 0,
                           float(scale), 0))
        return len(self._texs) - 1

    def image_texture(self, image) -> int:
        """Image texture from an [h, w, 3] float array in [0, 1] or a PNG
        or JPEG path, read at build time: its 8-bit values map to [0, 1]
        by / 255 with no sRGB decode, as the reference loads them."""
        if isinstance(image, (str, bytes)) or hasattr(image, "__fspath__"):
            from pathtrace_tpu_torch.render.film import read_image

            path = image.decode() if isinstance(image, bytes) else str(image)
            image = read_image(path).astype(np.float32) / 255.0
        img_id = len(self._images)
        self._images.append(np.asarray(image, dtype=np.float32))
        self._texs.append((T.TEX_IMAGE, np.zeros(3, np.float32), 0, 0, 0.0,
                           img_id))
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

    def isotropic(self, tex_id: int) -> int:
        return self._mat(T.MAT_ISOTROPIC, tex_id)

    # ---- primitives ----
    def sphere(self, center: Vec3, radius: float, mat_id: int,
               transform: Optional[np.ndarray] = None) -> None:
        """``transform``: an optional 3x4 world-from-object affine; the
        centre and radius are then in object space (any affine: a
        non-uniform scale makes an ellipsoid)."""
        self._sph.append((_v3(center), np.zeros(3, np.float32), 0.0, 0.0,
                          float(radius), mat_id, _opt_affine(transform)))

    def moving_sphere(self, center0: Vec3, center1: Vec3, time0: float,
                      time1: float, radius: float, mat_id: int,
                      transform: Optional[np.ndarray] = None) -> None:
        """A sphere whose centre moves linearly from ``center0`` at
        ``time0`` to ``center1`` at ``time1``: stored as (c0, c1 - c0,
        time0, 1 / (time1 - time0)), as the reference stores it."""
        c0, c1 = _v3(center0), _v3(center1)
        self._sph.append((c0, c1 - c0, float(time0), 1.0 / (time1 - time0),
                          float(radius), mat_id, _opt_affine(transform)))

    def _rect(self, axis: int, a0, a1, b0, b1, k, flip: bool, mat_id: int,
              transform) -> None:
        self._rects.append((axis, a0, a1, b0, b1, k, -1.0 if flip else 1.0,
                            mat_id, _opt_affine(transform)))

    def rect_xy(self, x0, x1, y0, y1, k, flip: bool, mat_id: int,
                transform=None) -> None:
        self._rect(2, x0, x1, y0, y1, k, flip, mat_id, transform)

    def rect_xz(self, x0, x1, z0, z1, k, flip: bool, mat_id: int,
                transform=None) -> None:
        self._rect(1, x0, x1, z0, z1, k, flip, mat_id, transform)

    def rect_yz(self, y0, y1, z0, z1, k, flip: bool, mat_id: int,
                transform=None) -> None:
        self._rect(0, y0, y1, z0, z1, k, flip, mat_id, transform)

    def box(self, p0: Vec3, p1: Vec3, mat_id: int,
            world_from_obj: Optional[np.ndarray] = None) -> None:
        m = (identity_affine() if world_from_obj is None
             else np.asarray(world_from_obj, np.float32))
        self._boxes.append((_v3(p0), _v3(p1), m, mat_id))

    def medium_box(self, p0: Vec3, p1: Vec3, density: float, albedo_tex: int,
                   world_from_obj: Optional[np.ndarray] = None) -> None:
        m = (identity_affine() if world_from_obj is None
             else np.asarray(world_from_obj, np.float32))
        mat = self.isotropic(albedo_tex)
        self._media.append((T.MEDIUM_BOX, _v3(p0), _v3(p1), 0.0, m,
                            float(density), mat))

    def medium_sphere(self, center: Vec3, radius: float, density: float,
                      albedo_tex: int) -> None:
        mat = self.isotropic(albedo_tex)
        self._media.append((T.MEDIUM_SPHERE, _v3(center),
                            np.zeros(3, np.float32), float(radius),
                            identity_affine(), float(density), mat))

    # ---- finish ----
    def finish(self, pad_multiple: int = 1,
               spatial_sort: bool = False) -> T.Scene:
        """Pad the sphere array to a multiple of ``pad_multiple`` and emit
        the Scene as CPU tensors.

        ``spatial_sort`` orders spheres by the Morton code of their
        mid-shutter centres ``c + 0.5 * delta`` (the reference's layout for
        tile culling; winner selection is a min over t, so order changes
        no image except at exact ties)."""
        f32, i32 = np.float32, np.int32

        if spatial_sort and len(self._sph) > 2:
            centers = np.stack([c + 0.5 * d for (c, d, *_rest) in self._sph])
            lo = centers.min(axis=0)
            ext = np.maximum(centers.max(axis=0) - lo, 1e-9)
            q = np.clip((centers - lo) / ext * 1023.0, 0.0, 1023.0)
            codes = _morton3(q.astype(np.uint32))
            order = np.argsort(codes, kind="stable")
            self._sph = [self._sph[i] for i in order]

        ns = _pad_to(len(self._sph), pad_multiple)
        # padding spheres sit at a huge far-away centre and are masked off
        sp_center = np.full((ns, 3), 1.0e18, f32)
        sp_delta = np.zeros((ns, 3), f32)
        sp_t0 = np.zeros(ns, f32)
        sp_invdt = np.zeros(ns, f32)
        sp_radius = np.zeros(ns, f32)
        sp_mat = np.zeros(ns, i32)
        sp_mask = np.zeros(ns, bool)
        # the affine pairs only where some sphere is instanced (identity
        # on the others and on the padding)
        sp_xf = any(x is not None for (*_, x) in self._sph)
        sp_wfo = np.tile(identity_affine()[None], (ns, 1, 1)) if sp_xf else None
        sp_ofw = np.tile(identity_affine()[None], (ns, 1, 1)) if sp_xf else None
        for i, (c, d, t0, invdt, r, m, xf) in enumerate(self._sph):
            sp_center[i] = c
            sp_delta[i] = d
            sp_t0[i] = t0
            sp_invdt[i] = invdt
            sp_radius[i] = r
            sp_mat[i] = m
            sp_mask[i] = True
            if xf is not None:
                sp_wfo[i] = xf
                sp_ofw[i] = invert_affine(xf)

        # padding rects lie on the plane k = 1e18 and are masked off
        nr = _pad_to(len(self._rects), 1)
        re_axis = np.zeros(nr, i32)
        re_span = np.zeros((4, nr), f32)   # a0, a1, b0, b1
        re_k = np.full(nr, 1.0e18, f32)
        re_flip = np.ones(nr, f32)
        re_mat = np.zeros(nr, i32)
        re_mask = np.zeros(nr, bool)
        re_xf = any(x is not None for (*_, x) in self._rects)
        re_wfo = np.tile(identity_affine()[None], (nr, 1, 1)) if re_xf else None
        re_ofw = np.tile(identity_affine()[None], (nr, 1, 1)) if re_xf else None
        for i, (ax, a0, a1, b0, b1, k, fl, m, xf) in enumerate(self._rects):
            re_axis[i] = ax
            re_span[:, i] = (a0, a1, b0, b1)
            re_k[i], re_flip[i], re_mat[i] = k, fl, m
            re_mask[i] = True
            if xf is not None:
                re_wfo[i] = xf
                re_ofw[i] = invert_affine(xf)

        # padding boxes and media sit at 1e18 and are masked off
        nb = _pad_to(len(self._boxes), 1)
        bx_p0 = np.full((nb, 3), 1.0e18, f32)
        bx_p1 = np.full((nb, 3), 1.0e18, f32)
        bx_wfo = np.tile(identity_affine()[None], (nb, 1, 1))
        bx_ofw = np.tile(identity_affine()[None], (nb, 1, 1))
        bx_mat = np.zeros(nb, i32)
        bx_mask = np.zeros(nb, bool)
        for i, (p0, p1, m, mat) in enumerate(self._boxes):
            bx_p0[i], bx_p1[i] = p0, p1
            bx_wfo[i] = m
            bx_ofw[i] = invert_affine(m)
            bx_mat[i] = mat
            bx_mask[i] = True

        nm = _pad_to(len(self._media), 1)
        md_kind = np.zeros(nm, i32)
        md_p0 = np.full((nm, 3), 1.0e18, f32)
        md_p1 = np.full((nm, 3), 1.0e18, f32)
        md_rad = np.zeros(nm, f32)
        md_wfo = np.tile(identity_affine()[None], (nm, 1, 1))
        md_ofw = np.tile(identity_affine()[None], (nm, 1, 1))
        md_den = np.ones(nm, f32)
        md_mat = np.zeros(nm, i32)
        md_mask = np.zeros(nm, bool)
        for i, (kind, p0, p1, rad, m, den, mat) in enumerate(self._media):
            md_kind[i] = kind
            md_p0[i], md_p1[i], md_rad[i] = p0, p1, rad
            md_wfo[i] = m
            md_ofw[i] = invert_affine(m)
            md_den[i] = den
            md_mat[i] = mat
            md_mask[i] = True

        def t(a):
            return None if a is None else torch.from_numpy(a)

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
        tx_img = np.zeros(ntex, i32)
        for i, (kind, color, odd, even, scale, img) in enumerate(self._texs):
            tx_kind[i] = kind
            tx_color[i] = color
            tx_odd[i], tx_even[i] = odd, even
            tx_scale[i] = scale
            tx_img[i] = img

        # the atlas: images stacked vertically, left-aligned
        if self._images:
            atlas = np.zeros((sum(im.shape[0] for im in self._images),
                              max(im.shape[1] for im in self._images), 3), f32)
            yoffs, hs, ws = [], [], []
            y = 0
            for im in self._images:
                h, w = im.shape[:2]
                atlas[y:y + h, :w] = im
                yoffs.append(y)
                hs.append(h)
                ws.append(w)
                y += h
            at = T.ImageAtlas(t(atlas), t(np.asarray(yoffs, i32)),
                              t(np.asarray(hs, i32)), t(np.asarray(ws, i32)))
        else:
            at = T.ImageAtlas.placeholder()

        sky = np.zeros(3, f32) if self.sky is None else _v3(self.sky)
        return T.Scene(
            spheres=T.Spheres(
                center=t(sp_center), center_delta=t(sp_delta),
                time0=t(sp_t0), inv_time_delta=t(sp_invdt),
                radius=t(sp_radius), mat_id=t(sp_mat), mask=t(sp_mask),
                world_from_obj=t(sp_wfo), obj_from_world=t(sp_ofw),
            ),
            rects=T.Rects(
                axis=t(re_axis), a0=t(re_span[0].copy()),
                a1=t(re_span[1].copy()), b0=t(re_span[2].copy()),
                b1=t(re_span[3].copy()), k=t(re_k), flip=t(re_flip),
                mat_id=t(re_mat), mask=t(re_mask),
                world_from_obj=t(re_wfo), obj_from_world=t(re_ofw),
            ),
            materials=T.Materials(t(ma_kind), t(ma_tex), t(ma_fuzz), t(ma_ref)),
            textures=T.Textures(t(tx_kind), t(tx_color), t(tx_odd), t(tx_even),
                                t(tx_scale), t(tx_img)),
            sky=t(sky),
            use_gradient_sky=torch.tensor(1.0 if self.sky is None else 0.0,
                                          dtype=torch.float32),
            boxes=T.Boxes(t(bx_p0), t(bx_p1), t(bx_wfo), t(bx_ofw), t(bx_mat),
                          t(bx_mask)),
            media=T.Media(t(md_kind), t(md_p0), t(md_p1), t(md_rad), t(md_wfo),
                          t(md_ofw), t(md_den), t(md_mat), t(md_mask)),
            atlas=at,
            perlin=make_perlin_tables(self._perlin_rng),
        )
