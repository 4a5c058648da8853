"""The port's drivers and surfaces on the CPU: the ``-X`` ray trace and
its BVH walk, the leaf test by global id, the live preview, the one-call
API, the throughput meter, ``compare_golden``, and the CLI's new flags
(``--group`` and ``--no-compaction`` bit for bit, ``--aovs``,
``--adaptive``, ``--denoise``, ``--profile-dir``, ``-R``, the interactive
loop, the TPU-only refusals).

JAX's side is the committed fixture ``tests/goldens/torch_port_drivers.npz``,
which this file's ``__main__`` writes (``PYTHONPATH=. python
tests/test_torch_drivers.py``, JAX on the CPU, ~2 min); the tests read it
and run no JAX:

* ``trace.small``, ``trace.cornell_bvh``: the lines of JAX's
  ``print_ray_trace`` of ``small`` (aspect 2, depth 5) and of ``cornell``
  with ``use_bvh`` (aspect 1, depth 3). The port's lines have the same
  structure, the same indices and words, every ``t=`` within rel 1e-5
  and the other numbers within 1e-4 (``torch_port_util.
  assert_trace_lines_match``; its sphere candidate is K1's, whose
  rounding is not XLA's);
* ``aov.<preset>.*``: ``render_aovs`` of ``cornell`` and ``random`` at
  48x48, 2 samples, ``PRNGKey(0)``; ``denoise.*``: JAX's 4-spp NEE frame of
  ``cornell`` at 48x48 (``PRNGKey(0)``, depth 8) and its ``atrous_denoise``
  guided by those AOVs; ``adaptive.<preset>.<route>.*``:
  ``render_adaptive`` of ``small`` (depth 4) and ``cornell`` (depth 6) at
  32x32, 2 samples a round, a budget of 8, seed 0, on the fast route
  (``mode="auto"``) and the general one. ``tests/test_torch_adaptive_aov.py``
  holds them.
"""

import io
import json
import os
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pathtrace_tpu_torch as pt  # noqa: E402
from pathtrace_tpu_torch import cli  # noqa: E402
from pathtrace_tpu_torch.config import Params  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.render import film  # noqa: E402
from pathtrace_tpu_torch.render.preview import PreviewServer  # noqa: E402
from pathtrace_tpu_torch.render.progressive import (  # noqa: E402
    render_progressive,
)
from pathtrace_tpu_torch.utils.debug import print_ray_trace  # noqa: E402
from pathtrace_tpu_torch.utils.profiling import (  # noqa: E402
    RenderStats,
    RollingMraysMeter,
)
from torch_port_util import assert_trace_lines_match  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_drivers.npz")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (fixture key, preset, aspect, max_depth, use_bvh) of the -X traces
TRACES = (("small", "small", 2.0, 5, False),
          ("cornell_bvh", "cornell", 1.0, 3, True))
# the AOV fixture: presets, film, samples, key
AOV_PRESETS = ("cornell", "random")
AOV_SIZE, AOV_SAMPLES, AOV_KEY = 48, 2, 0
# the denoiser's colour: cornell's NEE frame
DENOISE = {"preset": "cornell", "size": 48, "spp": 4, "depth": 8, "key": 0}
# the adaptive runs: (preset, max_depth); film, samples a round, budget
ADAPTIVE = (("small", 4), ("cornell", 6))
AD_SIZE, AD_SAMPLES, AD_BUDGET = 32, 2, 8
AD_ROUTES = ("auto", "general")


@pytest.fixture(scope="module")
def ref():
    return np.load(FIXTURE)


# ---------------------------------------------------------------------------
# -X: the single-ray trace and the BVH walk
# ---------------------------------------------------------------------------

def port_trace_lines(preset, aspect, depth, use_bvh, device="cpu"):
    scene, cam = presets.from_name(preset, aspect)
    lines = []
    print_ray_trace(scene, cam, depth, use_bvh=use_bvh, log=lines.append,
                    device=device)
    return lines


@pytest.mark.parametrize("case", TRACES, ids=[c[0] for c in TRACES])
def test_print_ray_trace_matches_jax(ref, case):
    key, preset, aspect, depth, use_bvh = case
    ref_lines = str(ref[f"trace.{key}"]).split("\n")
    lines = port_trace_lines(preset, aspect, depth, use_bvh)
    assert_trace_lines_match(lines, ref_lines)


def test_debug_trace_words():
    """Twins of ``tests/test_drivers.py``'s debug-trace tests."""
    text = "\n".join(port_trace_lines("small", 2.0, 5, False))
    assert "center ray" in text and "HIT" in text and "depth 0" in text
    text = "\n".join(port_trace_lines("cornell", 1.0, 3, True))
    for word in ("bvh stats", "node 0 inner: Hit", "leaf(prim",
                 "bvh visit census", "Hit t=", "depth 0"):
        assert word in text, word


@pytest.mark.parametrize("preset", ["cornell", "random", "cornell_smoke"])
def test_leaf_candidate_is_the_traversal_leaf_test(preset):
    """The leaf test by global id gives each winner's t bit for bit as
    the plain traversal found it, and MAX_T on an id the ray misses."""
    from pathtrace_tpu_torch.config import MAX_T
    from pathtrace_tpu_torch.models.bvh import build_scene_bvh
    from pathtrace_tpu_torch.ops import bvh_kernel
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    scene, cam = presets.from_name(preset, 1.0)
    f = SceneFeatures.from_scene(scene)
    flat, _, offsets = build_scene_bvh(scene)
    op = flat.operand(scene, f, offsets, "cpu")
    ro, rd, tm = generate_primary_rays(cam, 24, 24, 1, PRNGKey(5))
    R = 24 * 24
    rays = torch.cat([ro.reshape(R, 3).T, rd.reshape(R, 3).T]).contiguous()
    tm = tm.reshape(R)
    u = torch.from_numpy(np.random.default_rng(0).random(
        (scene.media.count, R), dtype=np.float32))
    flights = bvh_kernel.media_flights(op, u)
    t, gid = bvh_kernel.bvh_traverse_plain(op, rays, tm, flights)
    cand = bvh_kernel.leaf_candidate(op, gid, rays, tm, flights)
    hit = t < MAX_T
    assert hit.any()
    assert torch.equal(cand[hit], t[hit])
    # an id whose primitive the ray does not meet: the winner's t as the
    # bound leaves nothing nearer
    bounded = bvh_kernel.leaf_candidate(op, gid, rays, tm, flights,
                                        best_t=t.clone())
    assert bool((bounded[hit] == MAX_T).all())


# ---------------------------------------------------------------------------
# the live preview
# ---------------------------------------------------------------------------

def _get(url: str) -> bytes:
    return urllib.request.urlopen(url, timeout=10).read()


def _decode_png(png: bytes, tmp_path) -> np.ndarray:
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(png)
    return film.read_png(path)


def test_preview_serves_page_frame_and_stats(tmp_path):
    """Twin of ``tests/test_preview.py:12``, on a tensor."""
    srv = PreviewServer()
    try:
        img = np.random.default_rng(0).random((32, 48, 3)).astype(np.float32)
        srv.update(torch.from_numpy(img), frame=3, mrays_per_s=1.25)
        html = _get(srv.url)
        png = _get(srv.url + "frame.png")
        stats = json.loads(_get(srv.url + "stats.json"))
        assert b"pathtrace_tpu_torch" in html
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert stats == {"frame": 3, "mrays_per_s": 1.25, "width": 48,
                         "height": 32}
        np.testing.assert_array_equal(_decode_png(png, tmp_path),
                                      film.to_srgb_u8(img[::-1]))
        # a second fetch of the same frame is the cached encode
        assert _get(srv.url + "frame.png") == png and srv.encodes == 1
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.url + "nope")
    finally:
        srv.close()


def test_progressive_loop_updates_preview(tmp_path):
    """Twin of ``tests/test_preview.py:40``: the loop publishes every frame
    (by reference: the served frame is the accumulation it names)."""
    scene, cam = presets.small(1.0)
    seen = []
    urls = []

    def on_frame(frame, acc):
        seen.append((frame, acc))

    logs = []
    result = render_progressive(scene, cam, Params(width=16, height=16,
                                                   samples=1, max_depth=2),
                                max_frames=2, device="cpu", preview=True,
                                on_frame=on_frame, log=logs.append)
    assert result.frames == 2 and [f for f, _ in seen] == [1, 2]
    assert any(ln.startswith("live preview at http://127.0.0.1:")
               for ln in logs)
    # the last published tensor is the final image, untouched since
    np.testing.assert_array_equal(seen[-1][1].numpy(), result.image)
    # frames are new tensors: frame 1's was not written by frame 2
    assert seen[0][1].data_ptr() != seen[1][1].data_ptr()
    # the server is closed with the loop
    url = [ln.split()[-1] for ln in logs if "live preview" in ln][0]
    with pytest.raises(OSError):
        _get(url + "stats.json")


def test_preview_fetch_during_loop_returns_named_frame(tmp_path):
    """A fetch from inside the loop (the handler thread's readback) serves
    the frame the stats name, bit for bit the accumulation of that frame."""
    scene, cam = presets.small(1.0)
    got = {}

    from pathtrace_tpu_torch.render import preview as pv

    servers = []
    orig = pv.PreviewServer

    def make(*a, **k):
        srv = orig(*a, **k)
        servers.append(srv)
        return srv

    def on_frame(frame, acc):
        srv = servers[0]
        stats = json.loads(_get(srv.url + "stats.json"))
        png = _get(srv.url + "frame.png")
        got[frame] = (stats["frame"], _decode_png(png, tmp_path),
                      film.to_srgb_u8(acc.numpy()[::-1]))

    pv.PreviewServer = make
    try:
        render_progressive(scene, cam, Params(width=16, height=16, samples=1,
                                              max_depth=2),
                           max_frames=3, device="cpu", preview=True,
                           on_frame=on_frame, log=lambda _s: None)
    finally:
        pv.PreviewServer = orig
    assert sorted(got) == [1, 2, 3]
    for frame, (named, served, expect) in got.items():
        assert named == frame
        np.testing.assert_array_equal(served, expect)


# ---------------------------------------------------------------------------
# the one-call API
# ---------------------------------------------------------------------------

def test_api_preset_render(tmp_path):
    out = str(tmp_path / "o.png")
    img = pt.render_image(preset="small", width=64, height=32, samples=2,
                          max_depth=6, out=out, device="cpu")
    assert img.shape == (32, 64, 3) and np.isfinite(img).all()
    assert img.max() > 0.1
    assert film.read_png(out).shape == (32, 64, 3)


def test_api_custom_scene_render():
    b = pt.SceneBuilder()
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian_color((0.4, 0.8, 0.4)))
    cam = pt.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0),
                         60.0, 2.0, aperture=0.0, focus_dist=3.0)
    img = pt.render_image(scene=b.finish(), camera=cam, width=64, height=32,
                          samples=2, max_depth=4, device="cpu")
    assert img.shape == (32, 64, 3) and np.isfinite(img).all()


def test_api_matches_cli_bit_exact(tmp_path):
    """``render_image`` is the CLI's estimator: its image equals the CLI's
    ``.npy`` of the same flags, and the progressive driver's."""
    img_api = pt.render_image(preset="small", width=64, height=32, samples=2,
                              max_depth=6, seed=0, device="cpu")
    out = str(tmp_path / "c.npy")
    with redirect_stdout(io.StringIO()):
        rc = cli.main(["--device", "cpu", "-P", "small", "-W", "64", "-H",
                       "32", "-S", "2", "-D", "6", "-O", "--out", out])
    assert rc == 0
    np.testing.assert_array_equal(img_api, np.load(out))
    scene, cam = presets.from_name("small", 2.0, seed=0)
    res = render_progressive(scene, cam, Params(width=64, height=32,
                                                samples=2, max_depth=6),
                             max_frames=1, device="cpu", log=lambda _s: None)
    np.testing.assert_array_equal(img_api, res.image)


def test_api_arg_validation():
    with pytest.raises(ValueError):
        pt.render_image(device="cpu")
    with pytest.raises(ValueError):
        pt.render_image(preset="nope", width=8, height=8, device="cpu")
    b = pt.SceneBuilder()
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian_color((1.0, 0.0, 0.0)))
    with pytest.raises(ValueError):
        pt.render_image(scene=b.finish(), device="cpu")


def test_api_names_and_exports():
    names = pt.preset_names()
    assert "small" in names and "final_full" in names and "aras" in names
    for name in ("render_image", "preset_names", "make_camera", "Params",
                 "SceneBuilder"):
        assert hasattr(pt, name), name


def test_import_builds_no_cuda():
    """Importing the package loads neither JAX, nor torch until an export
    is used, nor a CUDA library."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import pathtrace_tpu_torch as pt\n"
            "assert 'torch' not in sys.modules\n"
            "from pathtrace_tpu_torch.ops import _cuda_build\n"
            "assert 'jax' not in sys.modules\n"
            "assert _cuda_build._LIB is None, 'a CUDA library was loaded'\n"
            "assert pt.render_image is pt.api.render\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={**os.environ, "PYTHONPATH": ROOT}, timeout=120)


# ---------------------------------------------------------------------------
# profiling and compare_golden
# ---------------------------------------------------------------------------

def test_render_stats_format():
    """Twin of ``tests/test_drivers.py:122``."""
    s = RenderStats(elapsed_secs=2.0, ray_count=4_000_000)
    assert s.mrays_per_sec == pytest.approx(2.0)
    assert "2.00Mrays/s" in s.summary()


def test_rolling_meter_reports_every_10_frames():
    """Twin of ``tests/test_drivers.py:127``."""
    m = RollingMraysMeter(report_every_frames=10, report_every_secs=1e9)
    reports = [o for o in (m.add_frame(1_000_000) for _ in range(25)) if o]
    assert len(reports) == 2
    assert "10frames" in reports[0] and "20frames" in reports[1]


def test_progressive_logs_the_meter():
    scene, cam = presets.small(1.0)
    logs = []
    render_progressive(scene, cam, Params(width=8, height=8, samples=1,
                                          max_depth=1),
                       max_frames=10, device="cpu", log=logs.append)
    assert sum("Mrays/frame 10frames" in ln for ln in logs) == 1


def _compare_golden(argv):
    from pathtrace_tpu_torch.tools import compare_golden

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = compare_golden.main(argv)
    return rc, buf.getvalue()


def test_compare_golden_two_pngs(tmp_path):
    """Twin of ``tests/test_drivers.py:137``."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    film.write_png(pa, a)
    b = np.clip(a.astype(int) + rng.integers(-2, 3, a.shape), 0, 255)
    film.write_png(pb, b.astype(np.uint8))
    rc, out = _compare_golden([pa, "--png", pb, "--downsample", "2"])
    assert rc == 0 and '"pass": true' in out
    # a different image fails
    film.write_png(pb, (255 - a).astype(np.uint8))
    rc, out = _compare_golden([pa, "--png", pb, "--downsample", "2"])
    assert rc == 1 and '"pass": false' in out


def test_compare_golden_renders_a_preset(tmp_path):
    """``--preset`` renders with the port (its general ``render_frame``)
    and compares in PNG space: the port's own PNG of the same render
    passes."""
    from pathtrace_tpu_torch.render.frame import render_frame
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    scene, cam = presets.from_name("small", 2.0)
    img, _ = render_frame(scene, cam, 32, 16, 2, 3, PRNGKey(0))
    ref_png = str(tmp_path / "ref.png")
    film.save_frame_png(ref_png, img.numpy())
    rc, out = _compare_golden([ref_png, "--preset", "small", "-W", "32",
                               "-H", "16", "-S", "2", "-D", "3",
                               "--device", "cpu"])
    rep = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and rep["pass"] and rep["mae"] == 0.0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["--device", "cpu", *argv])
    return rc, buf.getvalue()


def test_cli_parser_flags():
    """Twin of ``tests/test_drivers.py:29``: the reference's short flags
    and the drivers' flags parse."""
    a = cli.build_parser().parse_args(
        ["-W", "320", "-H", "200", "-S", "16", "-D", "5", "-R", "-B", "-P",
         "cornell", "-F", "3", "-O", "-X", "--aovs", "--adaptive", "8",
         "--denoise", "--group", "2", "--no-compaction", "--profile-dir",
         "d", "--no-preview", "--preview-port", "8123"])
    assert (a.width, a.height, a.samples, a.depth) == (320, 200, 16, 5)
    assert a.random and a.bvh and a.offline and a.print_trace
    assert a.aovs and a.adaptive == 8 and a.denoise and a.group == 2
    assert a.no_compaction and a.profile_dir == "d" and a.no_preview
    assert a.preview_port == 8123


def test_group_and_no_compaction_bit_exact(tmp_path):
    """Twin of ``tests/test_drivers.py:39``: ``--group`` and
    ``--no-compaction`` change no image bit."""
    base = ["-P", "small", "-W", "64", "-H", "32", "-S", "2", "-O"]
    outs = {}
    for name, extra in (("default", []), ("group2", ["--group", "2"]),
                        ("group3", ["--group", "3"]),
                        ("nocompact", ["--no-compaction", "--group", "1"])):
        out = str(tmp_path / f"{name}.npy")
        rc, _ = _cli(*base, *extra, "--out", out)
        assert rc == 0
        outs[name] = np.load(out)
    for name, img in outs.items():
        np.testing.assert_array_equal(img, outs["default"], err_msg=name)


@pytest.mark.parametrize("preset", ["random_spheres", "cornell"])
def test_trace_knobs_change_no_bit(preset):
    """The ladder at a size where it compacts (``min_size`` 128): every
    group and compaction on or off give the same radiance bit for bit and
    the same segment count; only the readbacks differ."""
    from pathtrace_tpu_torch.ops.fastpath import trace_fast
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    scene, cam = presets.from_name(preset, 2.0)
    f = SceneFeatures.from_scene(scene)
    ro, rd, tm = generate_primary_rays(cam, 32, 16, 2, PRNGKey(3))
    R = 32 * 16 * 2
    args = (scene, ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R), 77, 8,
            f)
    runs = {(g, c): trace_fast(*args, min_size=128, group=g, compaction=c)
            for g in (None, 2, 3) for c in (True, False)}
    base = runs[(None, True)]
    for k, res in runs.items():
        assert torch.equal(res.radiance, base.radiance), k
        assert int(res.ray_count) == int(base.ray_count), k
    assert runs[(3, True)].readbacks < base.readbacks
    with pytest.raises(ValueError):
        trace_fast(*args, group=0)


def test_cli_refusals_and_random_seed(tmp_path):
    for flag in (["--pallas"], ["--platform", "cpu"]):
        err = io.StringIO()
        from contextlib import redirect_stderr

        with redirect_stderr(err):
            rc, _ = _cli("-P", "small", "-O", *flag)
        assert rc == 2 and "TPU-only" in err.getvalue()
    rc, out = _cli("-P", "small", "-W", "16", "-H", "8", "-S", "1", "-D",
                   "2", "-O", "-R", "--out", str(tmp_path / "r.npy"))
    assert rc == 0 and "wrote" in out


def test_cli_trace_aovs_adaptive_denoise(tmp_path, ref):
    """``-X`` prints the trace and exits; ``--aovs`` writes three PNGs;
    ``--adaptive`` with ``--denoise`` writes the denoised image."""
    rc, out = _cli("-P", "small", "-W", "64", "-H", "32", "-D", "5", "-X")
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("center"))
    assert rc == 0
    assert_trace_lines_match(lines[start:],
                             str(ref["trace.small"]).split("\n"))
    prefix = str(tmp_path / "a")
    rc, out = _cli("-P", "cornell", "-W", "24", "-H", "24", "-S", "2", "-D",
                   "4", "--aovs", "--adaptive", "4", "--denoise", "--out",
                   prefix + ".png")
    assert rc == 0 and "adaptive: " in out and "denoise: " in out
    for suffix in ("", ".normal", ".albedo", ".depth"):
        assert film.read_png(prefix + suffix + ".png").shape == (24, 24, 3)


def test_cli_interactive_and_profile(tmp_path):
    """Without ``-O`` the progressive loop runs with the live preview to
    ``-F`` frames and writes ``--out``; ``--profile-dir`` writes a Chrome
    trace."""
    out = str(tmp_path / "i.npy")
    prof = str(tmp_path / "prof")
    rc, text = _cli("-P", "small", "-W", "16", "-H", "8", "-S", "1", "-D",
                    "2", "-F", "3", "--preview-port", "0", "--profile-dir",
                    prof, "--out", out)
    assert rc == 0 and "live preview at http://127.0.0.1:" in text
    assert "after 3 frames" in text and f"profiler trace written to {prof}" \
        in text
    assert np.load(out).shape == (8, 16, 3)
    with open(os.path.join(prof, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    rc, text = _cli("-P", "small", "-W", "16", "-H", "8", "-S", "1", "-D",
                    "2", "-F", "1", "--no-preview", "--out", out)
    assert rc == 0 and "live preview" not in text


def test_ctrl_c_ends_an_open_ended_render(monkeypatch, tmp_path):
    """The interactive CLI (no ``-O``, no ``-F``) renders until Ctrl-C and
    writes the frames done; offline runs and ``render_progressive`` let
    the interrupt through."""
    import pathtrace_tpu_torch.render.progressive as prog

    real = prog.render_frame_fast
    calls = []

    def interrupted_third(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return real(*a, **kw)

    monkeypatch.setattr(prog, "render_frame_fast", interrupted_third)
    film_args = ("-P", "small", "-W", "8", "-H", "8", "-S", "1", "-D", "1")
    out = str(tmp_path / "i.npy")
    rc, text = _cli(*film_args, "--no-preview", "--out", out)
    assert rc == 0 and "interrupted after 2 frames" in text
    assert f"wrote {out} after 2 frames" in text
    monkeypatch.setattr(prog, "render_frame_fast", real)
    ref = str(tmp_path / "r.npy")
    assert _cli(*film_args, "-O", "-F", "2", "--out", ref)[0] == 0
    np.testing.assert_array_equal(np.load(out), np.load(ref))

    monkeypatch.setattr(prog, "render_frame_fast", interrupted_third)
    calls.clear()
    with pytest.raises(KeyboardInterrupt):
        _cli(*film_args, "-O", "-F", "4", "--out", ref)
    calls.clear()
    scene, cam = presets.small(1.0)
    with pytest.raises(KeyboardInterrupt):
        render_progressive(scene, cam, Params(width=8, height=8, samples=1,
                                              max_depth=1),
                           max_frames=None, device="cpu", log=lambda _s: None)


# ---------------------------------------------------------------------------
# the fixture (JAX, CPU)
# ---------------------------------------------------------------------------

def write_fixture(path: str = FIXTURE) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pathtrace_tpu.config import Params as JParams
    from pathtrace_tpu.models import presets as jpresets
    from pathtrace_tpu.models.types import SceneFeatures as JFeatures
    from pathtrace_tpu.ops.lights import build_light_table
    from pathtrace_tpu.render.adaptive import render_adaptive
    from pathtrace_tpu.render.aov import render_aovs
    from pathtrace_tpu.render.denoise import atrous_denoise
    from pathtrace_tpu.render.frame import render_frame
    from pathtrace_tpu.utils.debug import print_ray_trace as jtrace

    out = {}
    for key, preset, aspect, depth, use_bvh in TRACES:
        js, jcam = jpresets.from_name(preset, aspect, seed=0)
        lines = []
        jtrace(js, jcam, depth, use_bvh=use_bvh, log=lines.append)
        out[f"trace.{key}"] = np.asarray("\n".join(lines))
    for preset in AOV_PRESETS:
        js, jcam = jpresets.from_name(preset, 1.0, seed=0)
        aovs = render_aovs(js, jcam, AOV_SIZE, AOV_SIZE,
                           jax.random.PRNGKey(AOV_KEY),
                           features=JFeatures.from_scene(js),
                           samples=AOV_SAMPLES)
        for k, v in aovs.items():
            out[f"aov.{preset}.{k}"] = np.asarray(v)
    d = DENOISE
    js, jcam = jpresets.from_name(d["preset"], 1.0, seed=0)
    feats = JFeatures.from_scene(js)
    color, _ = render_frame(js, jcam, d["size"], d["size"], d["spp"],
                            d["depth"], jax.random.PRNGKey(d["key"]),
                            features=feats,
                            nee_lights=build_light_table(js))
    a = {k: out[f"aov.{d['preset']}.{k}"] for k in ("normal", "albedo",
                                                      "depth")}
    out["denoise.color"] = np.asarray(color)
    out["denoise.out"] = np.asarray(atrous_denoise(
        jnp.asarray(color), jnp.asarray(a["normal"]),
        jnp.asarray(a["albedo"]), jnp.asarray(a["depth"])))
    # the rounds' pixel ids, as JAX's render_adaptive picks them
    picks = []
    argpartition = np.argpartition

    def spy(a, kth, *args, **kw):
        res = argpartition(a, kth, *args, **kw)
        picks.append(np.asarray(res)[kth:].copy())
        return res

    for preset, depth in ADAPTIVE:
        js, jcam = jpresets.from_name(preset, 1.0, seed=0)
        feats = JFeatures.from_scene(js)
        p = JParams(width=AD_SIZE, height=AD_SIZE, samples=AD_SAMPLES,
                    max_depth=depth, seed=0)
        for route in AD_ROUTES:
            picks.clear()
            np.argpartition = spy
            try:
                img, rays, spp = render_adaptive(js, jcam, p, AD_BUDGET,
                                                 features=feats, mode=route,
                                                 log=lambda _s: None)
            finally:
                np.argpartition = argpartition
            out[f"adaptive.{preset}.{route}.ids"] = np.stack(picks)
            out[f"adaptive.{preset}.{route}.img"] = np.asarray(img)
            out[f"adaptive.{preset}.{route}.spp"] = np.asarray(spp)
            out[f"adaptive.{preset}.{route}.rays"] = np.asarray(int(rays),
                                                                np.int64)
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    write_fixture()
