"""The port's fast-path slice against the JAX package, compaction
invariance, and the entry point.

``trace_fast`` with compaction on ``random_spheres``, ``small`` and the lit
scene of torch_port_util (2048 rays, depth 6, seed 7) against JAX's
``trace_fast`` on the same rays: the per-ray radiance holds the lane
contract (1e-3, at most 0.5% of rays outside), and the segment counts
differ by at most ``max_depth`` per ray outside. Measured on the CPU: 0.2% (random_spheres), 0% (small) and 0%
(lit) of rays outside.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models.types import SceneFeatures as JFeatures  # noqa: E402
from pathtrace_tpu.ops import fastpath as jfp  # noqa: E402
from pathtrace_tpu_torch.config import Params  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.render import compact_util  # noqa: E402
from torch_port_util import (  # noqa: E402
    check_slice_contract, jax_camera_rays, scene_pair,
)

ROOT = Path(__file__).resolve().parent.parent


def _port_trace(scene, ro, rd, tm, seed, depth, **kw):
    res = tfp.trace_fast(scene, torch.from_numpy(ro), torch.from_numpy(rd),
                         torch.from_numpy(tm), seed, depth,
                         SceneFeatures.from_scene(scene), **kw)
    return res.radiance.numpy(), int(res.ray_count)


@pytest.mark.parametrize("preset", ["random_spheres", "small", "lit"])
def test_trace_fast_matches_jax(preset):
    jscene, jcam, scene = scene_pair(preset, 16 / 9)
    ro, rd, tm = jax_camera_rays(jcam, 2048, seed=1)
    ref, ref_count = jfp.trace_fast(
        jscene, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm), 7, 6,
        JFeatures.from_scene(jscene), min_size=128)
    got, count = _port_trace(scene, ro, rd, tm, 7, 6, min_size=128)
    assert got.shape == (2048, 3)
    check_slice_contract(got, count, np.asarray(ref), int(ref_count), 6)


def _cover_rays(n):
    scene, cam = presets.random_spheres(16 / 9)
    g = np.random.default_rng(4)
    from pathtrace_tpu_torch.camera import get_rays

    ro, rd, tm = get_rays(cam, torch.from_numpy(g.random(n, dtype=np.float32)),
                          torch.from_numpy(g.random(n, dtype=np.float32)),
                          torch.from_numpy(g.random((n, 3), dtype=np.float32)))
    return scene, ro.numpy(), rd.numpy(), tm.numpy()


@pytest.mark.parametrize("tier", ["lanes", "rows"])
def test_compaction_bit_identical(tier, monkeypatch):
    """Stable lane ids and one emission per lane: compaction moves lanes
    and cannot change a bit of any ray's radiance or the segment count.
    ``rows`` forces the row tier (normally above 512k lanes)."""
    calls = []
    for name in ("compact", "compact_rows"):
        orig = getattr(compact_util, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(compact_util, name, spy)
    if tier == "rows":
        monkeypatch.setattr(tfp, "LANE_COMPACT_MAX", 256)
    scene, ro, rd, tm = _cover_rays(4096)
    a, ca = _port_trace(scene, ro, rd, tm, 5, 8, min_size=128)
    assert ("compact_rows" if tier == "rows" else "compact") in calls, calls
    b, cb = _port_trace(scene, ro, rd, tm, 5, 8, compaction=False)
    np.testing.assert_array_equal(a, b)
    assert ca == cb


def test_lane_ids_key_the_rng():
    """A ray's result does not depend on the rays beside it."""
    scene, ro, rd, tm = _cover_rays(1024)
    a, _ = _port_trace(scene, ro, rd, tm, 3, 6, compaction=False)
    b, _ = _port_trace(scene, ro[:1000], rd[:1000], tm[:1000], 3, 6,
                       compaction=False)
    np.testing.assert_array_equal(a[:1000], b)


def test_progressive_frames_on_cpu():
    from pathtrace_tpu_torch.render.progressive import render_progressive

    scene, cam = presets.small(16 / 12)
    params = Params(width=16, height=12, samples=2, max_depth=4)
    res = render_progressive(scene, cam, params, max_frames=2, device="cpu",
                             log=lambda _: None)
    assert res.image.shape == (12, 16, 3)
    assert np.isfinite(res.image).all() and 0.0 < res.image.mean() <= 1.0
    assert res.total_rays >= 2 * 16 * 12 * 2
    assert len(res.frame_ms) == 2 and res.timer == "host-clock"


def test_progressive_frames_are_keyed_as_the_reference():
    """Frame n of the progressive driver draws its rays from
    ``fold_in(PRNGKey(seed), n)`` and keys its bounces with ``seed *
    1000003 + n``, as the reference's fast mode does: its first frame is
    ``render_frame_fast`` at those keys, bit for bit, and a second frame
    blends in the next key's image."""
    from pathtrace_tpu_torch.render.progressive import render_progressive
    from pathtrace_tpu_torch.utils.threefry import PRNGKey, fold_in

    scene, cam = presets.aras(16 / 12)
    params = Params(width=16, height=12, samples=2, max_depth=4, seed=5)
    feats = SceneFeatures.from_scene(scene)
    frames = [tfp.render_frame_fast(scene, cam, 16, 12, 2, 4,
                                    fold_in(PRNGKey(5), n), 5 * 1000003 + n,
                                    feats).image.numpy() for n in range(2)]
    for n in (1, 2):
        res = render_progressive(scene, cam, params, max_frames=n,
                                 device="cpu", log=lambda _: None)
        want = frames[0] if n == 1 else 0.5 * frames[0] + 0.5 * frames[1]
        np.testing.assert_allclose(res.image, want, rtol=0, atol=1e-6)
    assert not np.array_equal(frames[0], frames[1])


@pytest.mark.parametrize("preset", ["smallpt", "aras", "final"])
def test_cli_renders_the_sphere_presets_on_cpu(preset, tmp_path):
    from pathtrace_tpu_torch.cli import main

    out = tmp_path / f"{preset}.npy"
    argv = ["--device", "cpu", "-P", preset, "-W", "16", "-H", "12", "-S",
            "2", "-D", "4", "-O", "--out", str(out)]
    assert main(argv) == 0
    img = np.load(out)
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    if preset == "final":  # the empty world: the gradient sky everywhere
        assert 0.5 < img.min() and img.max() < 1.0


def test_cli_stratify_is_latin_hypercube(tmp_path):
    """``--stratify`` renders through the stratified jitter: another image
    than the iid one from the same seed, with a mean within 5% of it."""
    from pathtrace_tpu_torch.cli import main

    imgs = {}
    for flag in ([], ["--stratify"]):
        out = tmp_path / f"small{len(flag)}.npy"
        assert main(["--device", "cpu", "-P", "small", "-W", "24", "-H", "16",
                     "-S", "4", "-D", "4", "-O", "--out", str(out),
                     *flag]) == 0
        imgs[bool(flag)] = np.load(out)
    assert not np.array_equal(imgs[True], imgs[False])
    assert abs(imgs[True].mean() / imgs[False].mean() - 1.0) < 0.05


def _run_port(code: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_renders_on_cpu_without_jax(tmp_path):
    out = tmp_path / "small.png"
    argv = ["--device", "cpu", "-P", "small", "-W", "32", "-H", "24",
            "-S", "2", "-D", "4", "-O", "--out", str(out)]
    proc = _run_port(
        "import sys\n"
        "from pathtrace_tpu_torch.cli import main\n"
        f"rc = main({argv!r})\n"
        "assert 'jax' not in sys.modules, 'the port loaded jax'\n"
        "sys.exit(rc)\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert re.search(r"^\d+\.\d+secs \d+rays \d+\.\d+Mrays/s$", proc.stdout,
                     re.M), proc.stdout
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_refuses_what_is_not_ported(capsys, tmp_path):
    from pathtrace_tpu_torch.cli import main

    # every flag of the JAX CLI is ported but the TPU-only ones
    assert main(["--pallas", "-O", "--device", "cpu"]) == 2
    assert "TPU-only" in capsys.readouterr().err
    assert main(["--no-such-flag", "-O", "--device", "cpu"]) == 2
    assert "unrecognized arguments" in capsys.readouterr().err
    # --mode sharded is ported: it renders
    out = tmp_path / "s.npy"
    assert main(["-P", "small", "-O", "--device", "cpu", "--mode", "sharded",
                 "-W", "16", "-H", "8", "-S", "1", "--out", str(out)]) == 0
    assert "render path: sharded" in capsys.readouterr().out
    assert np.isfinite(np.load(out)).all()
    if not torch.cuda.is_available():
        # no silent fallback to the CPU
        assert main(["-P", "small", "-O"]) == 2
        assert "CUDA is not available" in capsys.readouterr().err


def test_port_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|pathtrace_tpu)(\.|\s|$)", re.M)
    sources = sorted((ROOT / "pathtrace_tpu_torch").rglob("*.py"))
    assert sources
    for path in sources + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_wrappers_count_plain_calls_on_cpu():
    from pathtrace_tpu_torch.ops import intersect_kernel, shade_kernel

    k1, k2 = intersect_kernel.PLAIN_CALLS, shade_kernel.PLAIN_CALLS
    scene, ro, rd, tm = _cover_rays(256)
    _port_trace(scene, ro, rd, tm, 1, 2, compaction=False)
    assert intersect_kernel.PLAIN_CALLS - k1 == 3
    assert shade_kernel.PLAIN_CALLS - k2 == 3
