"""The port's render mesh (``parallel/mesh.py``), the device-only fast
trace, ``--mode sharded`` and the trainer on a mesh, held against the JAX
package's 8-device virtual CPU mesh.

Twins of tests/test_sharding.py on a virtual mesh of 8 CPU shards
(``make_render_mesh(["cpu"] * 8)``). JAX's side is the committed fixture
``tests/goldens/torch_port_sharded.npz``, which
``PYTHONPATH=. python tests/test_torch_sharding.py`` writes from the
reference on its 8 virtual CPU devices, so the test run needs no JAX.

Bounds, and why:

* fast shards key the bounce RNG on global lane ids, so the port's 8
  shards equal its one-shard ``trace_fast_device`` bit for bit (radiance
  and count), and that trace equals the ladder's ``trace_fast``, whose
  compaction keeps each lane's id;
* against JAX, per-ray radiance within 1e-3 with at most 0.5% of rays
  outside (the lane contract of ``tests/torch_port_util.py``; 1% at depth
  10, ``DEPTH10_BUDGET``), and ray counts equal: the padding lanes are
  born dead, so every count is the unpadded frame's;
* a frame's pixels (the mean of S rays) within 1e-3 except ``1 - (1 -
  b)^S`` of them;
* gradients within ``GRAD_TOL`` of JAX's 8-device gradients, the 8-shard
  and one-shard fast gradients within the reference's own bound (rtol
  2e-4, atol 1e-7);
* a mesh trainer's checkpoint resumes bit for bit.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.models.types import SceneFeatures  # noqa: E402
from pathtrace_tpu_torch.ops import fastpath as tfp  # noqa: E402
from pathtrace_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from pathtrace_tpu_torch.parallel.inverse import (  # noqa: E402
    make_inverse_renderer,
)
from pathtrace_tpu_torch.utils.threefry import PRNGKey  # noqa: E402
from torch_port_util import (  # noqa: E402
    DEPTH10_BUDGET,
    GRAD_TOL,
    assert_grads_close,
    check_slice_contract,
    lane_close,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_sharded.npz")
N_SHARDS = 8
LANE_BUDGET = 0.005


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def eight_mesh():
    return pmesh.make_render_mesh(["cpu"] * N_SHARDS)


@pytest.fixture(scope="module")
def one_mesh():
    return pmesh.make_render_mesh(["cpu"])


def _small():
    scene, cam = presets.small(1.0)
    return scene, cam, SceneFeatures.from_scene(scene)


def _pixels_close(img, ref_img, samples):
    """At most ``1 - (1 - b)^S`` of the pixels outside 1e-3 (b the lane
    budget): a pixel is the mean of S rays, each of which may flip."""
    close = lane_close(img, ref_img).all(axis=-1)
    budget = 1.0 - (1.0 - LANE_BUDGET) ** samples
    frac = float((~close).mean())
    assert frac <= budget, f"{frac:.4%} of pixels beyond 1e-3"
    return frac


# ---------------------------------------------------------------------------
# the mesh and global lanes
# ---------------------------------------------------------------------------

def test_mesh_shards_and_padding():
    mesh = pmesh.make_render_mesh(["cpu", "cpu", "cpu"])
    assert mesh.size == mesh.n_local == 3 and mesh.world == 1
    assert mesh.rank == 0 and mesh.group is None
    assert [s for s, _ in mesh.shards()] == [0, 1, 2]
    assert mesh.home == torch.device("cpu")
    assert pmesh.pad_to_multiple(100, 8) == 104
    assert pmesh.pad_to_multiple(104, 8) == 104
    with pytest.raises(ValueError, match="no devices"):
        pmesh.make_render_mesh([])
    if not torch.cuda.is_available():
        # no fallback to the CPU: the CPU only when the caller names it
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_render_mesh()


def test_lane_ids_are_global():
    lane, alive = tfp.lane_ids(6, "cpu", lane_offset=10, alive_limit=13)
    assert lane.dtype == torch.int32
    assert lane.tolist() == [10, 11, 12, 13, 14, 15]
    assert alive.tolist() == [True, True, True, False, False, False]
    # the uint32 bit pattern past 2^31
    lane, alive = tfp.lane_ids(2, "cpu", lane_offset=(1 << 31) - 1)
    assert lane.tolist() == [(1 << 31) - 1, -(1 << 31)] and alive.all()
    st = tfp.make_state(torch.zeros(4, 3), torch.ones(4, 3), torch.zeros(4),
                        lane_offset=4, alive_limit=6)
    assert st.lane.tolist() == [4, 5, 6, 7]
    assert st.alive.tolist() == [True, True, False, False]


def test_fold_seed_is_the_reference_fold(ref):
    from pathtrace_tpu_torch.utils.threefry import split

    _, ktrace = split(PRNGKey(0))
    assert pmesh.fold_seed(5, ktrace) == int(ref["fast_frame.seed"])


# ---------------------------------------------------------------------------
# the device-only fast trace (tests/test_sharding.py:53-75)
# ---------------------------------------------------------------------------

def test_fast_trace_sharded_bit_identical_and_holds_jax(ref, eight_mesh):
    scene, _, feats = _small()
    ro, rd, tm = (torch.from_numpy(ref[f"fast_trace.{k}"])
                  for k in ("ro", "rd", "time"))
    seed, depth = int(ref["fast_trace.seed"]), int(ref["fast_trace.depth"])
    rad_sh, cnt_sh = pmesh.trace_sharded(scene, ro, rd, tm, None, depth,
                                         eight_mesh, features=feats,
                                         mode="fast", seed=seed)
    rad_1, cnt_1 = tfp.trace_fast_device(scene, ro, rd, tm, seed, depth,
                                         feats)
    assert torch.equal(rad_sh, rad_1) and int(cnt_sh) == int(cnt_1)
    # the ladder's trace keeps lane ids under compaction: the same bits
    res = tfp.trace_fast(scene, ro, rd, tm, seed, depth, feats, min_size=128)
    assert torch.equal(res.radiance, rad_1)
    assert int(res.ray_count) == int(cnt_1)
    check_slice_contract(rad_sh.numpy(), cnt_sh, ref["fast_trace.radiance"],
                         ref["fast_trace.count"], depth, budget=LANE_BUDGET)


def test_fast_trace_device_takes_a_tree_and_moving_spheres():
    """``-B``: the tree is the device trace's closest hit, as it is the
    ladder's, and sharding keeps the bits; ``random`` runs K3's plain
    version in every shard."""
    from pathtrace_tpu_torch.models import bvh as pbvh
    from pathtrace_tpu_torch.render.frame import generate_primary_rays

    mesh = pmesh.make_render_mesh(["cpu"] * 4)
    for name in ("small", "random"):
        scene, cam = presets.from_name(name, 2.0)
        feats = SceneFeatures.from_scene(scene)
        tree = pbvh.build_scene_bvh(scene)
        ro, rd, tm = (x.reshape(-1, *x.shape[3:]) for x in
                      generate_primary_rays(cam, 16, 8, 2, PRNGKey(1)))
        kw = dict(bvh=tree[0], bvh_offsets=tree[2]) if name == "small" else {}
        rad_1, cnt_1 = tfp.trace_fast_device(scene, ro, rd, tm, 9, 5, feats,
                                             **kw)
        rad_4, cnt_4 = pmesh.trace_sharded(scene, ro, rd, tm, None, 5, mesh,
                                           features=feats, mode="fast",
                                           seed=9, **kw)
        assert torch.equal(rad_1, rad_4) and int(cnt_1) == int(cnt_4), name
        res = tfp.trace_fast(scene, ro, rd, tm, 9, 5, feats, min_size=128,
                             **kw)
        assert torch.equal(res.radiance, rad_1), name
        assert torch.isfinite(rad_1).all() and int(cnt_1) >= ro.shape[0]


# ---------------------------------------------------------------------------
# frames (tests/test_sharding.py:22-51, 76-105)
# ---------------------------------------------------------------------------

def test_fast_frame_with_padding(ref, eight_mesh, one_mesh):
    """20x10x1 = 200 rays over 8 shards (padded to 200, JAX to 8 * 1024):
    born-dead padding keeps the count exact; lanes are global, so the
    image is the one-shard frame's bit for bit."""
    scene, cam, feats = _small()
    out = {}
    for label, mesh in (("eight", eight_mesh), ("one", one_mesh)):
        out[label] = pmesh.render_frame_sharded(
            scene, cam, 20, 10, 1, 4, PRNGKey(0), mesh, features=feats,
            mode="fast", seed=5)
    img, count = out["eight"]
    assert img.shape == (10, 20, 3) and torch.isfinite(img).all()
    assert torch.equal(img, out["one"][0])
    assert int(count) == int(out["one"][1])
    assert 200 <= int(count) <= 200 * 5
    _pixels_close(img.numpy(), ref["fast_frame.image"], 1)
    assert int(count) == int(ref["fast_frame.count"])


def test_general_frame_padded_to_mesh_multiple(ref, eight_mesh):
    """10x10x1 = 100 rays over 8 shards of 13 (4 padding lanes born dead
    by a NaN time); shard s keyed ``fold_in(ktrace, s)`` as JAX's."""
    scene, cam, feats = _small()
    img, count = pmesh.render_frame_sharded(
        scene, cam, 10, 10, 1, 4, PRNGKey(0), eight_mesh, features=feats)
    assert img.shape == (10, 10, 3)
    _pixels_close(img.numpy(), ref["general_frame.image"], 1)
    assert int(count) == int(ref["general_frame.count"])


def test_estimator_frame_matches_jax_and_unsharded(ref, eight_mesh):
    """32x32x8, depth 6: the 8-shard general frame holds JAX's 8-device
    frame pixel by pixel, and the unsharded estimator statistically
    (different streams: per-shard keys)."""
    from pathtrace_tpu_torch.render.frame import render_frame

    scene, cam, feats = _small()
    img, count = pmesh.render_frame_sharded(
        scene, cam, 32, 32, 8, 6, PRNGKey(0), eight_mesh, features=feats)
    _pixels_close(img.numpy(), ref["estimator.image"], 8)
    assert abs(int(count) - int(ref["estimator.count"])) <= \
        DEPTH10_BUDGET * 32 * 32 * 8 * 6
    local, local_count = render_frame(scene, cam, 32, 32, 8, 6, PRNGKey(0),
                                      features=feats)
    assert abs(float(img.mean()) - float(local.mean())) < 0.02
    assert int(count) > 0 and int(local_count) > 0


def test_ray_count_sum_is_total(ref, eight_mesh):
    scene, _, feats = _small()
    n = 8 * 16
    ro = torch.tensor([[3.0, 3.0, 2.0]]).repeat(n, 1)
    d = torch.tensor([[-0.57, -0.58, -0.57]])
    rd = (d / d.norm()).repeat(n, 1)
    rad, count = pmesh.trace_sharded(scene, ro, rd, torch.zeros(n),
                                     PRNGKey(0), 6, eight_mesh,
                                     features=feats)
    assert rad.shape == (n, 3)
    assert int(count) >= n
    assert int(count) == int(ref["count_sum.count"])


# ---------------------------------------------------------------------------
# the trainer on a mesh (tests/test_sharding.py:106-236)
# ---------------------------------------------------------------------------

def _grads(mesh, use_fast_path, key=PRNGKey(5)):
    scene, cam, _ = _small()
    renderer, state, names = make_inverse_renderer(
        scene, cam, 16, 16, samples=4, max_depth=3, mesh=mesh,
        use_fast_path=use_fast_path)
    loss = renderer.loss(state.params, torch.zeros(16, 16, 3), key)
    grads = torch.autograd.grad(loss, state.params)
    return renderer, float(loss.detach()), names, [g.numpy() for g in grads]


@pytest.mark.parametrize("route", ["fast", "general"])
def test_train_step_gradients_hold_jax(ref, eight_mesh, route):
    renderer, loss, names, grads = _grads(eight_mesh, route == "fast")
    assert renderer.use_fast_path == (route == "fast")
    assert names == list(ref[f"train_{route}.names"])
    assert abs(loss - float(ref[f"train_{route}.loss"])) <= \
        1e-3 * abs(float(ref[f"train_{route}.loss"]))
    assert_grads_close(grads, [ref[f"train_{route}.grad.{n}"] for n in names],
                       names, GRAD_TOL, f"{route} 8 shards vs JAX")


def test_fast_gradients_shard_invariant(eight_mesh, one_mesh):
    """The reference's ``test_fast_diff_gradients_shard_invariant``: the
    forward is bit for bit the one-shard forward; the gradients sum the
    shards' contributions in another order."""
    _, loss1, names, g1 = _grads(one_mesh, None)
    _, loss8, _, g8 = _grads(eight_mesh, None)
    assert loss1 == loss8
    for name, a, b in zip(names, g1, g8):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-7, err_msg=name)
    assert np.abs(g1[names.index("spheres.center")]).max() > 0.0


def _color_trainer(mesh):
    scene, cam, _ = _small()
    return make_inverse_renderer(
        scene, cam, 16, 16, samples=2, max_depth=3, mesh=mesh,
        learning_rate=2e-2, trainable=lambda p: "textures.color" in p)


def test_train_step_runs_and_reduces_loss(eight_mesh):
    renderer, state, names = _color_trainer(eight_mesh)
    assert names == ["textures.color"]
    key = PRNGKey(1)
    with torch.no_grad():
        target = renderer.render(state.params, key)
    state = renderer.init([(p.detach() + 0.2).requires_grad_(True)
                           for p in state.params])
    losses = []
    for _ in range(5):
        state, loss = renderer.train_step(state, target, key)
        losses.append(float(loss))
    assert losses[-1] < losses[0] and np.isfinite(losses).all()


def test_train_checkpoint_resume_bit_exact(eight_mesh, tmp_path):
    """train(5) == train(2) -> save -> load -> train(3), bit for bit, on
    the 8-shard mesh (the reference's ``:174-220``)."""
    from pathtrace_tpu_torch.utils import checkpoint as ckpt

    renderer, state, _ = _color_trainer(eight_mesh)
    key = PRNGKey(3)
    with torch.no_grad():
        target = renderer.render(state.params, key)
    perturbed = [p.detach() + 0.15 for p in state.params]

    def fresh_from(values):
        return renderer.init([v.clone().requires_grad_(True) for v in values])

    s_full = fresh_from(perturbed)
    for _ in range(5):
        s_full, _ = renderer.train_step(s_full, target, key)
    s_half = fresh_from(perturbed)
    for _ in range(2):
        s_half, _ = renderer.train_step(s_half, target, key)
    path = str(tmp_path / "train.npz")
    ckpt.save_train(path, s_half, key)
    renderer2, template, _ = _color_trainer(eight_mesh)
    s_res, saved_key = ckpt.load_train(path, template)
    assert s_res.step == 2 and torch.equal(saved_key, key)
    for _ in range(3):
        s_res, _ = renderer2.train_step(s_res, target, saved_key)
    assert s_res.step == s_full.step == 5
    for a, b in zip(s_full.params, s_res.params):
        assert torch.equal(a, b)
    for a, b in zip(s_full.optimizer.state.values(),
                    s_res.optimizer.state.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[k], b[k]), k
    # a template of other leaves is refused, as in the reference
    _, state_more, _ = make_inverse_renderer(
        *_small()[:2], 16, 16, samples=2, max_depth=2, mesh=eight_mesh)
    with pytest.raises(ValueError, match="configuration mismatch"):
        ckpt.load_train(path, state_more)


def test_gradients_flow_to_geometry(eight_mesh):
    scene, cam, _ = _small()
    renderer, state, names = make_inverse_renderer(
        scene, cam, 16, 16, samples=2, max_depth=2, mesh=eight_mesh)
    loss = renderer.loss(state.params, torch.zeros(16, 16, 3), PRNGKey(2))
    grads = dict(zip(names, torch.autograd.grad(loss, state.params)))
    g = grads["spheres.center"]
    assert torch.isfinite(g).all() and g.abs().max() > 0.0


def test_dryrun_multichip_on_virtual_shards(capsys):
    from pathtrace_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(N_SHARDS, device="cpu")
    assert np.isfinite(out["loss"]) and out["step"] == 1
    assert out["names"] == ["spheres.center", "spheres.center_delta",
                            "textures.color"]
    assert f"dryrun_multichip({N_SHARDS})" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# --mode sharded through the progressive driver and the CLI
# ---------------------------------------------------------------------------

def _progressive(mesh, preset="small", use_bvh=False, **kw):
    from pathtrace_tpu_torch.config import Params
    from pathtrace_tpu_torch.render.progressive import render_progressive

    scene, cam = presets.from_name(preset, 2.0)
    params = Params(width=16, height=8, samples=2, max_depth=4, seed=3,
                    use_bvh=use_bvh)
    lines = []
    res = render_progressive(scene, cam, params, max_frames=2, device="cpu",
                             mode="sharded", mesh=mesh, log=lines.append,
                             **kw)
    return res, "\n".join(lines)


def test_progressive_sharded_is_shard_count_invariant(eight_mesh, one_mesh):
    """Fast shards: 8 shards render the one-shard frames bit for bit, the
    tree (``-B``) too; ``--nee``, ``--rr`` and ``--stratify`` are ignored
    with the reference's log line."""
    a, log = _progressive(eight_mesh)
    b, _ = _progressive(one_mesh)
    assert a.path == b.path == "sharded" and a.readbacks == [0, 0]
    assert np.array_equal(a.image, b.image) and a.total_rays == b.total_rays
    assert "8 shard(s)" in log and "fast shards" in log
    c, log = _progressive(eight_mesh, "simple_light", use_bvh=True, nee=True,
                          rr_start=2, stratify=True)
    d, _ = _progressive(one_mesh, "simple_light", use_bvh=True)
    assert np.array_equal(c.image, d.image) and np.isfinite(c.image).all()
    assert "nee: ignored in --mode sharded" in log
    assert "rr, stratify: ignored in --mode sharded" in log
    assert "(sharded path, bvh)" in log


def test_progressive_sharded_general_shards_drop_the_tree(eight_mesh):
    """A scene the fast path refuses (instances) takes general shards,
    which drop ``-B``'s tree with the reference's log line."""
    from pathtrace_tpu_torch.models.build import SceneBuilder

    b = SceneBuilder()
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian_color((0.5, 0.5, 0.5)))
    b.sphere((0.0, 0.0, -1.0), 0.5, b.metal((0.8, 0.6, 0.2), 0.1),
             transform=np.diag([1.0, 2.0, 1.0, 1.0])[:3])
    scene = b.finish()
    _, cam = presets.small(2.0)
    assert tfp.fastpath_refusal(SceneFeatures.from_scene(scene),
                                scene) is not None
    from pathtrace_tpu_torch.config import Params
    from pathtrace_tpu_torch.render.progressive import render_progressive

    lines = []
    res = render_progressive(
        scene, cam, Params(width=16, height=8, samples=1, max_depth=3,
                           use_bvh=True), max_frames=1, device="cpu",
        mode="sharded", mesh=eight_mesh, log=lines.append)
    log = "\n".join(lines)
    assert res.path == "sharded" and np.isfinite(res.image).all()
    assert "rendering sharded WITHOUT the tree" in log
    assert "general shards" in log and "(sharded path, sweep)" in log


def test_cli_mode_sharded_and_distributed_needs_torchrun(tmp_path, capsys,
                                                         monkeypatch):
    from pathtrace_tpu_torch import cli

    out = tmp_path / "s.npy"
    argv = ["-P", "small", "-W", "16", "-H", "8", "-S", "2", "-D", "3", "-O",
            "--device", "cpu", "--mode", "sharded", "--out", str(out)]
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    assert "render path: sharded (--mode sharded" in text
    assert "(sharded path, sweep)" in text
    assert np.isfinite(np.load(out)).all()
    for k in pmesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        cli.main(argv + ["--distributed"])


if __name__ == "__main__":
    import sys

    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={N_SHARDS}").strip()
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from pathtrace_tpu.models import presets as jpresets
    from pathtrace_tpu.models.types import SceneFeatures as JFeatures
    from pathtrace_tpu.ops.fastpath import trace_fast_device
    from pathtrace_tpu.parallel import mesh as jmesh
    from pathtrace_tpu.parallel.inverse import make_inverse_renderer as jinv

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    assert len(jax.devices()) == N_SHARDS
    mesh = jmesh.make_render_mesh()
    scene, cam = jpresets.small(aspect=1.0)
    feats = JFeatures.from_scene(scene)
    out = {}

    # tests/test_sharding.py:53-75
    n = N_SHARDS * 1024
    key = jax.random.PRNGKey(7)
    ro = jax.random.uniform(key, (n, 3), minval=-2.0, maxval=2.0) + \
        jnp.asarray([3.0, 3.0, 2.0])
    rd = jax.random.normal(jax.random.PRNGKey(8), (n, 3))
    rd = rd / jnp.linalg.norm(rd, axis=1, keepdims=True)
    t = jnp.zeros(n, jnp.float32)
    rad, cnt = jmesh.trace_sharded(scene, ro, rd, t, key, 6, mesh,
                                   features=feats, mode="fast", seed=3)
    rad1, cnt1 = trace_fast_device(scene, ro, rd, t, 3, 6, feats)
    assert np.array_equal(np.asarray(rad), np.asarray(rad1))
    out.update({"fast_trace.ro": np.asarray(ro), "fast_trace.rd": np.asarray(rd),
                "fast_trace.time": np.asarray(t), "fast_trace.seed": 3,
                "fast_trace.depth": 6, "fast_trace.radiance": np.asarray(rad),
                "fast_trace.count": int(cnt)})

    # :76-93, with the folded seed the frame traced with
    kd = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.PRNGKey(0))[1])).ravel()
    out["fast_frame.seed"] = int((np.uint32(5) ^ kd[-1]).astype(np.int32))
    img, cnt = jmesh.render_frame_sharded(
        scene, cam, 20, 10, 1, 4, jax.random.PRNGKey(0), mesh,
        features=feats, mode="fast", seed=5)
    out.update({"fast_frame.image": np.asarray(img),
                "fast_frame.count": int(cnt)})
    # :94-105
    img, cnt = jmesh.render_frame_sharded(
        scene, cam, 10, 10, 1, 4, jax.random.PRNGKey(0), mesh, features=feats)
    out.update({"general_frame.image": np.asarray(img),
                "general_frame.count": int(cnt)})
    # :22-39
    img, cnt = jmesh.render_frame_sharded(
        scene, cam, 32, 32, 8, 6, jax.random.PRNGKey(0), mesh, features=feats)
    out.update({"estimator.image": np.asarray(img),
                "estimator.count": int(cnt)})
    # :40-51
    m = N_SHARDS * 16
    ro = jnp.tile(jnp.asarray([[3.0, 3.0, 2.0]], jnp.float32), (m, 1))
    d = jnp.asarray([[-0.57, -0.58, -0.57]], jnp.float32)
    rd = jnp.tile(d / jnp.linalg.norm(d), (m, 1))
    _, cnt = jmesh.trace_sharded(scene, ro, rd, jnp.zeros(m, jnp.float32),
                                 jax.random.PRNGKey(0), 6, mesh,
                                 features=feats)
    out["count_sum.count"] = int(cnt)
    # :134-172: loss and gradients of one step, both routes
    for route, fast in (("fast", True), ("general", False)):
        renderer, state, names = jinv(scene, cam, 16, 16, samples=4,
                                      max_depth=3, mesh=mesh,
                                      use_fast_path=fast)
        target = jnp.zeros((16, 16, 3))
        loss, grads = jax.value_and_grad(renderer.loss)(
            state.params, target, jax.random.PRNGKey(5))
        out[f"train_{route}.loss"] = float(loss)
        out[f"train_{route}.names"] = np.asarray(names)
        for name, g in zip(names, grads):
            out[f"train_{route}.grad.{name}"] = np.asarray(g)
    # tools/distributed_smoke.py's computation on the 8 devices
    import distributed_smoke

    path = os.path.join(os.path.dirname(FIXTURE), "_smoke.npz")
    distributed_smoke._compute(path)
    smoke = np.load(path)
    for k in ("loss", "ray_count", "grad"):
        out[f"smoke.{k}"] = np.asarray(smoke[k])
    os.remove(path)
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
