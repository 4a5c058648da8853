"""Image textures on the port's fast path against the JAX package (CPU).

* The builder: two images of different sizes, one an array and one a PNG
  path (written by the port's ``encode_png``), build leaves equal to
  JAX's bit for bit, the atlas included; ``earth`` and its procedural map
  likewise; ``scene_from_numpy(scene_to_numpy(s))`` keeps the atlas.
* The readers: the port's ``read_png`` (filters 0-4, and Pillow's PNG) and
  ``decode_jpeg`` (Pillow's baseline 4:4:4, 4:2:0 and progressive) equal
  the JAX package's bit for bit on the same bytes.
* The tables: the 28-column sphere and rect rows of an image scene equal
  ``build_sphere_table`` / ``build_rect_table`` bit for bit, rows whose
  texture is not an image included (they carry image 0's atlas entry).
* The pre-pass: the port's ``image_texel_index`` against the reference's
  ``_image_rgb_planes`` run on an atlas whose texels hold their own
  (row, column), on earth's primary and scattered winners and on the
  port's ``presets.image_light_scene``'s (sphere and rect UV): the
  share of lanes whose texel differs is printed and must fit the lane
  contract (0.5%; measured 0). Edge lanes: the poles, both sides of the
  seam (``atan2(+-0, ny < 0)``), rect corners, lanes on dead rows (an
  image of width 0) and a missed lane, where the port must pick the
  reference's texel on every lane.
* The plain K2 with ``FLAG_IMAGE`` against ``shade_bounce_planes``
  (Pallas in interpret mode, its texels from the reference's pre-pass)
  under the lane contract: plain on earth, with ``FLAG_RECT`` and
  ``FLAG_EMIT_SCALE`` on the image-light scene (the normal and albedo
  rows against ``_normal_planes`` / ``_albedo_planes`` with the texels
  overriding the albedo), and with ``FLAG_MOTION`` on a moving image
  sphere.
* The depth-10 ``trace_fast`` against the committed fixtures
  ``tests/goldens/torch_port_earth.npz`` (plain) and
  ``tests/goldens/torch_port_image_light_nee.npz`` (NEE and roulette
  from depth 3): JAX's fused ``trace_fast`` on 4096 camera rays, radiance
  within 1e-3 with at most ``DEPTH10_BUDGET`` of the rays outside,
  segments equal where no ray is outside. Regenerate them with
  ``PYTHONPATH=. python tests/test_torch_images.py``.
* The gates: an image on a box or in a media scene takes the non-fused
  bounce, and the fused device-only trace raises ``ValueError`` naming
  the reference's gate; so do an atlas entry outside the atlas data
  and K2's image flag without the atlas; the megakernel refuses image
  scenes, the differentiable path takes them; the CLI renders ``-P earth`` and
  ``--image`` (a missing file is an error, rc 2).
"""

import functools
import io
import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import build as jbuild  # noqa: E402
from pathtrace_tpu.models import presets as jpresets  # noqa: E402
from pathtrace_tpu.models.types import SceneFeatures as JFeatures  # noqa: E402
from pathtrace_tpu.ops import fastpath as jfp  # noqa: E402
from pathtrace_tpu.ops import lights as jlights  # noqa: E402
from pathtrace_tpu.render import film as jfilm  # noqa: E402
from pathtrace_tpu.render import jpeg as jjpeg  # noqa: E402
from pathtrace_tpu_torch import cli  # noqa: E402
from pathtrace_tpu_torch.models import build, convert, presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.ops import lights, megakernel  # noqa: E402
from pathtrace_tpu_torch.ops import shade_kernel  # noqa: E402
from pathtrace_tpu_torch.render import film, jpeg  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET, PLANE_NAMES, assert_lanes_close, check_slice_contract,
    jax_camera_rays, jax_fused_state, jax_scene_leaves,
    jax_scene_winners, jax_shade_planes,
)

ASPECT = 16 / 9
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
EARTH_FIXTURE = os.path.join(GOLDENS, "torch_port_earth.npz")
LIGHT_FIXTURE = os.path.join(GOLDENS, "torch_port_image_light_nee.npz")
N_RAYS, SEED, MAX_DEPTH, UNIFORM_SEED, RR_START = 4096, 7, 10, 2026, 3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@functools.lru_cache(maxsize=None)
def _scenes(name):
    """(JAX scene, JAX camera, port scene) of ``earth``, the image-light
    scene (``simple_light``'s camera) or the moving image sphere."""
    if name == "earth":
        jscene, jcam = jpresets.earth(ASPECT)
        return jscene, jcam, presets.earth(ASPECT)[0]
    if name == "image_light":
        return (presets.image_light_scene(
                    jbuild, jpresets._procedural_earth_image()),
                jpresets.simple_light(ASPECT)[1],
                presets.image_light_scene(build,
                                          presets._procedural_earth_image()))
    scenes = []
    for mod, pre in ((jbuild, jpresets), (build, presets)):
        b = mod.SceneBuilder()
        img = b.lambertian(b.image_texture(pre._procedural_earth_image(32)))
        b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian_color((0.5,) * 3))
        b.moving_sphere((0.0, 1.0, 0.0), (0.0, 2.5, 0.0), 0.0, 1.0, 1.0, img)
        b.moving_sphere((2.0, 0.7, 1.0), (1.0, 0.7, 1.5), 0.0, 1.0, 0.7, img)
        scenes.append(b.finish())
    return scenes[0], jpresets.random(ASPECT)[1], scenes[1]


# ---------------------------------------------------------------------------
# the builder and the readers
# ---------------------------------------------------------------------------

def _two_image_scenes(tmp_path):
    """Both packages' scene of an array image (24 x 40) and a PNG path
    (the port's ``encode_png`` of a 33 x 17 image) on two spheres, and a
    constant-textured sphere between them."""
    g = np.random.default_rng(5)
    arr = g.random((24, 40, 3), dtype=np.float32)
    png = tmp_path / "tex.png"
    png.write_bytes(film.encode_png(g.integers(0, 256, (33, 17, 3),
                                               dtype=np.uint8)))
    out = []
    for mod in (jbuild, build):
        b = mod.SceneBuilder()
        b.sphere((0.0, 0.0, 0.0), 1.0, b.lambertian(b.image_texture(arr)))
        b.sphere((3.0, 0.0, 0.0), 1.0, b.lambertian_color((0.2, 0.3, 0.4)))
        b.sphere((6.0, 0.0, 0.0), 1.0, b.lambertian(b.image_texture(png)))
        out.append(b.finish())
    return out


def _assert_leaves_equal(jscene, scene):
    ref = jax_scene_leaves(jscene)
    got = convert.scene_to_numpy(scene)
    assert set(got) == set(ref)
    for key, val in got.items():
        assert _bits_equal(ref[key], val), key


def test_builder_atlas_equals_jax(tmp_path):
    jscene, scene = _two_image_scenes(tmp_path)
    _assert_leaves_equal(jscene, scene)
    at = scene.atlas
    assert tuple(at.data.shape) == (57, 40, 3)
    assert at.y_offset.tolist() == [0, 24] and at.width.tolist() == [40, 17]
    assert scene.textures.image_id.tolist() == [0, 0, 1]
    back = convert.scene_from_numpy(convert.scene_to_numpy(scene),
                                    device="cpu")
    for key, val in convert.scene_to_numpy(back).items():
        assert _bits_equal(convert.scene_to_numpy(scene)[key], val), key


def test_earth_equals_jax_leaf_for_leaf():
    assert _bits_equal(jpresets._procedural_earth_image(),
                       presets._procedural_earth_image())
    jscene, _, scene = _scenes("earth")
    _assert_leaves_equal(jscene, scene)
    # the converted JAX scene is the port's preset
    conv = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    _assert_leaves_equal(jscene, conv)
    # a scene without images: the 1x1 placeholder, as JAX's builder gives
    _assert_leaves_equal(jpresets.small(ASPECT)[0], presets.small(ASPECT)[0])


def _png_with_filters(img):
    """PNG bytes of ``img`` whose rows cycle through filters 0-4."""
    h, w, _ = img.shape
    stride = w * 3
    rows = img.reshape(h, stride).astype(np.int32)
    raw = b""
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        cur, f = rows[y], y % 5
        a = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        c = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        if f == 0:
            pred = np.zeros(stride, np.int32)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _smooth_image(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 120 * np.sin(xx / 17.0) * np.cos(yy / 23.0),
                    127 + 120 * np.cos(xx / 31.0),
                    127 + 120 * np.sin((xx + yy) / 29.0)], axis=-1)
    img += rng.normal(0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["filters", "pillow"])
def test_read_png_equals_jax(tmp_path, kind):
    img = _smooth_image(37, 21, seed=2)
    path = tmp_path / "a.png"
    if kind == "filters":
        path.write_bytes(_png_with_filters(img))
    else:
        pil = pytest.importorskip("PIL.Image")
        pil.fromarray(img).save(path, "PNG")
    got = film.read_png(str(path))
    np.testing.assert_array_equal(got, img)
    assert _bits_equal(got, jfilm.read_png(str(path)))
    assert _bits_equal(film.read_image(str(path)), got)


@pytest.mark.parametrize("mode", ["444", "420", "progressive"])
def test_decode_jpeg_equals_jax(tmp_path, mode):
    pil = pytest.importorskip("PIL.Image")
    img = _smooth_image(67, 35)
    kw = {"444": {"subsampling": 0}, "420": {"subsampling": 2},
          "progressive": {"subsampling": 2, "progressive": True}}[mode]
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, "JPEG", quality=90, **kw)
    data = buf.getvalue()
    got = jpeg.decode_jpeg(data)
    assert got.shape == (35, 67, 3) and got.dtype == np.uint8
    assert _bits_equal(got, jjpeg.decode_jpeg(data))
    assert np.abs(got.astype(np.int32) - img).mean() < 8.0
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    assert _bits_equal(film.read_image(str(path)), got)


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

def test_image_tables_bitwise():
    jscene, _, scene = _scenes("image_light")
    jfeat = JFeatures.from_scene(jscene)
    feats = SceneFeatures.from_scene(scene)
    assert feats._key() == jfeat._key() and feats.has_image
    k = tfp.attr_width(feats)
    assert k == jfp.attr_width(jfeat) == 28
    for jfn, fn in ((jfp.build_sphere_table, tfp.build_sphere_table),
                    (jfp.build_rect_table, tfp.build_rect_table)):
        ref = np.asarray(jfn(jscene, k))
        got = fn(scene, k).numpy()
        assert _bits_equal(ref, got), fn.__name__
    sph = tfp.build_sphere_table(scene, k).numpy()
    # the earth sphere's row: image 0; the marble ground's: image 0's entry
    assert sph[1, 3] == 3.0 and sph[1, -3:].tolist() == [0.0, 256.0, 512.0]
    assert sph[0, 3] == 2.0 and sph[0, -3:].tolist() == [0.0, 256.0, 512.0]
    rect = tfp.build_rect_table(scene, k).numpy()
    assert rect[1, -3:].tolist() == [256.0, 40.0, 72.0]
    assert np.all(sph[3:, -3:] == 0.0)  # dead and padding rows
    tables = tfp.prep_tables(scene, feats)
    assert _bits_equal(tables.atlas.numpy(), scene.atlas.data.numpy())
    assert tfp.feature_flags(feats) & shade_kernel.FLAG_IMAGE


# ---------------------------------------------------------------------------
# the pre-pass
# ---------------------------------------------------------------------------

def _index_atlas(jscene):
    """The reference's [3, N] atlas planes whose texel (y, x) holds
    (y, x, 0): its pre-pass then returns the texel it picked."""
    h, w = np.asarray(jscene.atlas.data).shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = np.stack([yy.ravel(), xx.ravel(), np.zeros(h * w, np.float32)])
    return jnp.asarray(planes), jnp.int32(w)


def _texel_flips(jscene, table, st, t, idx, flags):
    """(lanes whose texel differs, the port's (atlas row, column) per
    lane): the port's ``image_texel_index`` against the reference's
    ``_image_rgb_planes`` on the index atlas, for the winners (t, idx) of
    state ``st``."""
    planes = st.planes
    R = t.shape[0]
    attrs = table[idx]
    col = [_t(attrs[:, k]) for k in range(attrs.shape[1])]
    ts = torch.where(_t(t) < 1e30, _t(t), 0.0)
    px, py, pz = (planes[k] + ts * planes[3 + k] for k in range(3))
    ii, jj, y0 = shade_kernel.image_texel_index(col, px, py, pz, st.time,
                                                flags)
    attrs3 = jnp.asarray(np.ascontiguousarray(
        attrs.reshape(R // 128, 128, -1).transpose(0, 2, 1)))
    ref = jfp._image_rgb_planes(_index_atlas(jscene), jnp.asarray(t), attrs3,
                                jax_fused_state(st), JFeatures.from_scene(jscene))
    got_y, got_x = (y0 + jj).numpy(), ii.numpy()
    flips = int(((got_y != np.asarray(ref[0]))
                 | (got_x != np.asarray(ref[1]))).sum())
    return flips, got_y, got_x


@pytest.mark.parametrize("name", ["earth", "image_light"])
def test_image_prepass_matches_jax(name):
    """Texel indices of the port's pre-pass twin against the reference's
    over two bounces (primary and scattered winners) of camera rays: the
    share of texel flips is printed (measured 0) and must fit the lane
    contract. The image-light scene's winners include image rects."""
    jscene, jcam, scene = _scenes(name)
    feats = SceneFeatures.from_scene(scene)
    tables = tfp.prep_tables(scene, feats)
    table = tables.table.numpy()
    flags = tfp.feature_flags(feats)
    n = 2048
    ro, rd, tm = jax_camera_rays(jcam, n, seed=3)
    st = tfp.make_state(_t(ro), _t(rd), _t(tm))
    rect_img, img_lanes = 0, []
    for depth in range(2):
        planes = st.planes.numpy()
        t, idx = jax_scene_winners(jscene, planes[0:3].T, planes[3:6].T)
        is_img = (t < 1e30) & (table[idx, 3] == 3.0)
        img_lanes.append(int(is_img.sum()))
        rect_img += int((is_img & (table[idx, 14] == 1.0)).sum())
        flips = _texel_flips(jscene, table, st, t, idx, flags)[0]
        print(f"{name} depth {depth}: {flips} texel flips of {n} lanes "
              f"({flips / n:.4%}), {img_lanes[-1]} image lanes")
        assert flips / n <= 0.005
        out, alive = shade_kernel.shade_from_winners(
            tables.table, _t(idx), _t(t), st.planes, st.time, st.alive,
            st.lane, 11, depth, 8, tables.sky4, flags, atlas=tables.atlas)
        st = tfp.FastStateP(out, st.time, alive, st.lane)
    # a convex globe's scattered rays all miss: earth's image lanes are
    # its primary ones
    assert img_lanes[0] > 0.1 * n
    assert (img_lanes[1] > 0.02 * n) == (name == "image_light")
    assert (rect_img > 0) == (name == "image_light")


def test_image_prepass_edge_lanes():
    """Lanes at t = 0 on exact points (so p = ro) of the image-light
    scene, whose sphere 1 is an earth globe of radius 2 at (0, 2, 0):
    its poles, both sides of its seam (x = +0 and -0 below the equator:
    ``atan2(+-0, ny < 0)`` is +-pi, the first and the last column),
    random points, a missed lane and lanes whose winner is a dead row (an
    image of width 0: texel 0); then the back wall's corners (u, v at 0
    and 1: the clamps). The port picks the reference's texel on every
    lane."""
    jscene, _, scene = _scenes("image_light")
    feats = SceneFeatures.from_scene(scene)
    tables = tfp.prep_tables(scene, feats)
    table = tables.table.numpy()
    flags = tfp.feature_flags(feats)
    g = np.random.default_rng(2)
    pts = [(0.0, 4.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1e-30),
           (0.0, 1.0, 1.7320508), (-0.0, 1.0, 1.7320508),
           (0.0, 1.0, -1.7320508), (-0.0, 1.0, -1.7320508),
           (2.0, 2.0, 0.0), (-2.0, 2.0, 0.0), (0.0, 2.0, 2.0)]
    n = 512
    d = g.normal(size=(n - len(pts), 3))
    d = 2.0 * d / np.linalg.norm(d, axis=1, keepdims=True) + (0.0, 2.0, 0.0)
    ro = np.concatenate([np.asarray(pts), d]).astype(np.float32)
    # rd.x = -0 keeps the sign of a -0 start: p.x = -0 + 0 * -0 = -0
    rd = np.tile(np.float32([-0.0, 0.0, -1.0]), (n, 1))
    st = tfp.make_state(_t(ro), _t(rd), torch.zeros(n))
    t = np.zeros(n, np.float32)
    idx = np.ones(n, np.int32)
    t[-1] = np.finfo(np.float32).max  # a miss
    idx[-9:-1] = 5                    # dead sphere rows
    flips, gy, gx = _texel_flips(jscene, table, st, t, idx, flags)
    assert flips == 0, f"{flips} of {n} edge lanes pick another texel"
    assert (gy[0], gy[1]) == (0, 255)
    assert (gx[3], gx[4], gx[5], gx[6]) == (0, 511, 0, 511)
    assert np.all(gx[-9:-1] == 0) and np.all(gy[-9:-1] == 0)
    # the back wall: rect 1, a yz rect at x = -6 over y [0, 8], z [-7, 7]
    # wearing image 1 (40 x 72 texels from atlas row 256)
    corners = np.float32([[-6.0, 0.0, -7.0], [-6.0, 8.0, 7.0],
                          [-6.0, 0.0, 7.0], [-6.0, 8.0, -7.0]])
    ro = np.concatenate([corners, np.zeros((124, 3), np.float32)])
    st = tfp.make_state(_t(ro), _t(np.tile(np.float32([1, 0, 0]), (128, 1))),
                        torch.zeros(128))
    idx = np.full(128, tables.rows.rect + 1, np.int32)
    flips, gy, gx = _texel_flips(jscene, table, st, np.zeros(128, np.float32),
                                 idx, flags)
    assert flips == 0
    assert gx[:4].tolist() == [0, 71, 0, 71]
    assert gy[:4].tolist() == [256 + 39, 256, 256, 256 + 39]


# ---------------------------------------------------------------------------
# K2's image branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["earth", "image_light_nee", "motion"])
def test_k2_image_branch_matches_jax(case):
    """Three bounces: the plain K2 with ``FLAG_IMAGE`` against
    ``shade_bounce_planes`` (texels from the reference's pre-pass) under
    the lane contract; with ``FLAG_EMIT_SCALE`` also its normal and
    albedo rows against ``_normal_planes`` / ``_albedo_planes`` with the
    texels overriding the albedo; a lane whose texture is an image
    takes the texel as its albedo."""
    name = {"earth": "earth", "image_light_nee": "image_light",
            "motion": "motion"}[case]
    jscene, jcam, scene = _scenes(name)
    feats = SceneFeatures.from_scene(scene)
    jfeat = JFeatures.from_scene(jscene)
    tables = tfp.prep_tables(scene, feats)
    table = tables.table.numpy()
    flags = tfp.feature_flags(feats)
    assert flags & shade_kernel.FLAG_IMAGE
    assert bool(flags & shade_kernel.FLAG_MOTION) == (case == "motion")
    emit = case == "image_light_nee"
    n = 1024
    ro, rd, tm = jax_camera_rays(jcam, n, seed=5)
    st = tfp.make_state(_t(ro), _t(rd), _t(tm))
    g = np.random.default_rng(6)
    img_lanes = 0
    for depth in range(3):
        planes = st.planes.numpy()
        if case == "motion":
            t, idx = (x.numpy() for x in tfp.closest_hit(tables, st, depth,
                                                          feats))
        else:
            t, idx = jax_scene_winners(jscene, planes[0:3].T, planes[3:6].T)
        hit = t < 1e30
        is_img = hit & (table[idx, 3] == 3.0)
        img_lanes += int(is_img.sum())
        esc = g.random(n, dtype=np.float32) if emit else None
        ref = jax_shade_planes(jscene, table, t, idx, st, 11, depth, 8,
                               emit_scale=esc)
        st_in = st
        if emit:
            st_in = tfp.FastStateP(torch.cat([st.planes, _t(esc)[None]]),
                                   st.time, st.alive, st.lane)
        out, alive = shade_kernel.shade_from_winners(
            tables.table, _t(idx), _t(t), st_in.planes, st.time, st.alive,
            st.lane, 11, depth, 8, tables.sky4,
            flags | (shade_kernel.FLAG_EMIT_SCALE if emit else 0),
            atlas=tables.atlas)
        for k, plane in enumerate(PLANE_NAMES):
            assert_lanes_close(out[k].numpy(), ref[k],
                               what=f"{case} depth {depth} {plane}")
        assert (alive.numpy() == (ref[12] > 0.5)).mean() >= 0.995
        if emit:
            attrs3 = jnp.asarray(np.ascontiguousarray(
                table[idx].reshape(n // 128, 128, -1).transpose(0, 2, 1)))
            jst = jax_fused_state(st)
            nx, ny, nz, point = jfp._normal_planes(jnp.asarray(t), attrs3,
                                                   jst, jfeat)
            img = jfp._image_rgb_planes(jfp._atlas_planes(jscene),
                                        jnp.asarray(t), attrs3, jst, jfeat)
            alb = jfp._albedo_planes(jnp.asarray(t), attrs3, point, jfeat,
                                     img_planes=img)
            for k, ref_k in enumerate((nx, ny, nz, *alb)):
                assert_lanes_close(out[13 + k].numpy()[hit],
                                   np.asarray(ref_k)[hit],
                                   what=f"depth {depth} extra row {13 + k}")
            albedo = out[shade_kernel.ALBEDO].numpy()
            texel = np.stack([np.asarray(c) for c in img])
            same = (albedo[:, is_img] == texel[:, is_img]).all(axis=0)
            assert same.mean() >= 0.995
        st = tfp.FastStateP(out[:12], st.time, alive, st.lane)
    assert img_lanes > 100


# ---------------------------------------------------------------------------
# the traces against the committed fixtures
# ---------------------------------------------------------------------------

def _fixture_kw(scene_or_jscene, nee, mod_lights):
    if not nee:
        return {}
    return {"nee_lights": mod_lights.build_light_table(scene_or_jscene),
            "rr_start": RR_START}


def make_fixture(name) -> dict:
    """4096 camera rays (numpy uniforms) and JAX's fused ``trace_fast``
    at depth 10: ``earth`` plain, the image-light scene with NEE and
    roulette from depth 3."""
    jscene, jcam, _ = _scenes(name)
    nee = name == "image_light"
    ro, rd, tm = jax_camera_rays(jcam, N_RAYS, seed=UNIFORM_SEED)
    rad, count = jfp.trace_fast(
        jscene, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm), SEED,
        MAX_DEPTH, JFeatures.from_scene(jscene), min_size=128,
        **_fixture_kw(jscene, nee, jlights))
    return {"rays.ro": ro, "rays.rd": rd, "rays.time": tm,
            "seed": np.int64(SEED), "max_depth": np.int64(MAX_DEPTH),
            "rr_start": np.int64(RR_START if nee else 0),
            "radiance": np.asarray(rad), "ray_count": np.int64(int(count))}


@pytest.mark.parametrize("name,path", [("earth", EARTH_FIXTURE),
                                       ("image_light", LIGHT_FIXTURE)])
def test_port_cpu_trace_holds_image_fixture(name, path):
    ref = np.load(path)
    rays = jax_camera_rays(_scenes(name)[1], N_RAYS, seed=UNIFORM_SEED)
    for key, val in zip(("rays.ro", "rays.rd", "rays.time"), rays):
        np.testing.assert_array_equal(ref[key], val)
    scene = _scenes(name)[2]
    res = tfp.trace_fast(
        scene, *(_t(ref[k]) for k in ("rays.ro", "rays.rd", "rays.time")),
        int(ref["seed"]), int(ref["max_depth"]),
        SceneFeatures.from_scene(scene), min_size=128,
        **_fixture_kw(scene, name == "image_light", lights))
    rad, count = res.radiance.numpy(), int(res.ray_count)
    assert np.isfinite(rad).all() and rad.shape == (N_RAYS, 3)
    frac = check_slice_contract(rad, count, ref["radiance"],
                                ref["ray_count"], MAX_DEPTH,
                                budget=DEPTH10_BUDGET)
    print(f"{name}: {frac:.4%} of rays outside 1e-3, segments {count} vs "
          f"{int(ref['ray_count'])}")
    if frac == 0.0:
        assert count == int(ref["ray_count"])
    assert rad.mean() > 0.01


# ---------------------------------------------------------------------------
# the gates and the CLI
# ---------------------------------------------------------------------------

def test_gates_on_image_scenes():
    """Images on spheres and rects take the fast path; an image on a box,
    or in a scene with media, takes its non-fused bounce, and the fused
    device-only trace raises naming the reference's gate; the megakernel
    refuses image scenes; the differentiable path takes them all, as the
    reference's does (its image branch has the box UV)."""
    scene = _scenes("image_light")[2]
    feats = SceneFeatures.from_scene(scene)
    assert tfp.fastpath_supported(feats, scene)
    assert not megakernel.megakernel_supported(feats)
    assert tfp.diff_supported(feats, scene)
    rad, _ = tfp.trace_fast_diff(scene, torch.zeros(8, 3),
                                 torch.tensor([[0.0, 0.0, 1.0]] * 8),
                                 torch.zeros(8), 0, 2, feats)
    assert rad.shape == (8, 3) and torch.isfinite(rad).all()
    for kind in ("box", "medium"):
        b = build.SceneBuilder()
        img = b.image_texture(np.ones((4, 8, 3), np.float32))
        b.sphere((0.0, -100.0, 0.0), 100.0, b.lambertian(img))
        if kind == "box":
            b.box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), b.lambertian(img))
        else:
            b.medium_sphere((0.0, 1.0, 0.0), 1.0, 0.5,
                            b.constant_texture((0.5, 0.5, 0.5)))
        s = b.finish()
        f = SceneFeatures.from_scene(s)
        assert tfp.fastpath_supported(f, s)
        assert "fused_shade_supported" in tfp.fused_refusal(f, s)
        assert tfp.diff_supported(f, s)
        down = (torch.zeros(8, 3), torch.tensor([[0.0, -1.0, 0.0]] * 8),
                torch.zeros(8))
        rad = tfp.trace_fast(s, *down, 0, 2, f).radiance
        assert rad.shape == (8, 3) and torch.isfinite(rad).all()
        with pytest.raises(ValueError, match="box UV"):
            tfp.trace_fast_device(s, *down, 0, 2, f)
    # an atlas entry outside the atlas data (a converted scene's) is refused
    bad = convert.scene_to_numpy(scene)
    bad["atlas.height"] = bad["atlas.height"] + np.int32(1)
    bad = convert.scene_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="outside the atlas"):
        tfp.prep_tables(bad, SceneFeatures.from_scene(bad))
    # K2 refuses FLAG_IMAGE without the atlas
    tables = tfp.prep_tables(scene, feats)
    st = tfp.make_state(torch.zeros(8, 3), torch.tensor([[0.0, 0.0, 1.0]] * 8),
                        torch.zeros(8))
    with pytest.raises(ValueError, match="atlas"):
        shade_kernel.shade_from_winners(
            tables.table, torch.zeros(8, dtype=torch.int32), torch.ones(8),
            st.planes, st.time, st.alive, st.lane, 0, 0, 2, tables.sky4,
            shade_kernel.FLAG_IMAGE)


@pytest.mark.parametrize("image", [False, True])
def test_cli_renders_earth(tmp_path, capsys, image):
    out = tmp_path / "earth.npy"
    argv = ["--device", "cpu", "-P", "earth", "-W", "64", "-H", "36", "-S",
            "2", "-O", "--out", str(out)]
    if image:
        png = tmp_path / "map.png"
        png.write_bytes(film.encode_png(np.full((8, 16, 3), [200, 40, 40],
                                                np.uint8)))
        argv += ["--image", str(png)]
    assert cli.main(argv) == 0
    img = np.load(out)
    assert img.shape == (36, 64, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0
    if image:  # the globe is red where the default map is blue and green
        globe = img[12:24, 26:38].reshape(-1, 3).mean(axis=0)
        assert globe[0] > 2.0 * globe[2]
    assert "wrote" in capsys.readouterr().out
    if image:
        argv[-1] = str(tmp_path / "none.png")
        assert cli.main(argv) == 2
        assert "none.png" in capsys.readouterr().err


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for name, path in (("earth", EARTH_FIXTURE),
                       ("image_light", LIGHT_FIXTURE)):
        np.savez_compressed(path, **make_fixture(name))
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
