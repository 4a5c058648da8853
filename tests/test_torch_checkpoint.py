"""Render and TrainState checkpoints of the port (``utils/checkpoint.py``):
bit-exact resume of the progressive render, the CLI, the trainer and the
example, the reference's ``.npz`` layout, and checkpoints crossing between
the packages.

Twins of tests/test_drivers.py's ``TestCheckpoint`` and
``test_accumulates_and_resumes_bit_exact`` and of tests/test_sharding.py's
``test_train_checkpoint_resume_bit_exact`` and
``test_load_train_rejects_mismatched_template``, on one device. Resume is
held bit for bit (the reference's render twin allows 1e-6; the port's
frames are a deterministic function of (seed, frame), so no allowance is
needed).

Across the packages: ``tests/goldens/torch_port_train_ckpt.npz`` is a
checkpoint the JAX package wrote after 2 Adam steps of the trainer
problem below, and ``torch_port_train_resume.npz`` its state after 3 more
steps; both come from ``PYTHONPATH=. python tests/test_torch_checkpoint.py``
(JAX on the CPU). The port loads the first, takes the 3 steps and lands
within 1e-3 relative L2 of JAX's displacement per leaf (the trainer's
bound in tests/test_torch_grad.py); a checkpoint the port writes loads
through JAX's ``load_train`` into JAX's own TrainState leaf for leaf.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch import cli  # noqa: E402
from pathtrace_tpu_torch.config import Params  # noqa: E402
from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.parallel import inverse as tinv  # noqa: E402
from pathtrace_tpu_torch.render.progressive import (  # noqa: E402
    render_progressive,
)
from pathtrace_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from pathtrace_tpu_torch.utils.threefry import PRNGKey  # noqa: E402
from torch_port_util import rel_l2  # noqa: E402

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
JAX_CKPT = os.path.join(GOLDENS, "torch_port_train_ckpt.npz")
JAX_RESUME = os.path.join(GOLDENS, "torch_port_train_resume.npz")
W = H = 16


def _trainer(trainable=lambda p: "textures.color" in p):
    """tests/test_sharding.py's problem: ``small`` at 16x16 x2, depth 3,
    the colours, lr 2e-2, the target at PRNGKey(3), colours +0.15."""
    scene, cam = presets.small(1.0)
    renderer, state, names = tinv.make_inverse_renderer(
        scene, cam, W, H, samples=2, max_depth=3, device="cpu",
        learning_rate=2e-2, trainable=trainable)
    key = PRNGKey(3)
    with torch.no_grad():
        target = renderer.render(state.params, key)
        for p in state.params:
            p.add_(0.15)
    return renderer, state, names, target, key


def _opt_leaves(state):
    return ckpt.train_leaves(state)


class TestRenderCheckpoint:
    def test_roundtrip(self, tmp_path):
        path = str(tmp_path / "c.npz")
        img = np.random.default_rng(1).random((8, 8, 3)).astype(np.float32)
        ckpt.save(path, img, 17, 42)
        img2, frame, seed = ckpt.load(path)
        np.testing.assert_array_equal(img, img2)
        assert (frame, seed) == (17, 42)

    def test_try_load_missing(self, tmp_path):
        assert ckpt.try_load(str(tmp_path / "none.npz")) is None
        assert ckpt.try_load(None) is None

    def test_reference_reads_the_port_and_back(self, tmp_path):
        from pathtrace_tpu.utils import checkpoint as jckpt

        a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
        img = np.random.default_rng(2).random((4, 6, 3)).astype(np.float32)
        ckpt.save(a, torch.from_numpy(img), 5, 9)
        got = jckpt.load(a)
        np.testing.assert_array_equal(got[0], img)
        assert got[1:] == (5, 9)
        jckpt.save(b, img, 6, 10)
        got = ckpt.load(b)
        np.testing.assert_array_equal(got[0], img)
        assert got[1:] == (6, 10)


@pytest.mark.parametrize("mode", ["fast", "general"])
def test_progressive_resumes_bit_exact(tmp_path, mode):
    scene, cam = presets.small(1.0)
    params = Params(width=16, height=16, samples=2, max_depth=3)
    ck = str(tmp_path / "ck.npz")
    logs = []
    r_all = render_progressive(scene, cam, params, 4, "cpu", mode=mode,
                               log=logs.append)
    r_a = render_progressive(scene, cam, params, 2, "cpu", mode=mode,
                             checkpoint_path=ck, log=logs.append)
    assert ckpt.load(ck)[1] == 2
    r_b = render_progressive(scene, cam, params, 2, "cpu", mode=mode,
                             checkpoint_path=ck, log=logs.append)
    assert any("resumed" in line for line in logs)
    assert r_a.frames == r_b.frames == 2 and ckpt.load(ck)[1] == 4
    np.testing.assert_array_equal(r_all.image, r_b.image)
    assert not np.array_equal(r_a.image, r_b.image)
    # another seed's checkpoint is not resumed
    other = Params(width=16, height=16, samples=2, max_depth=3, seed=5)
    r_c = render_progressive(scene, cam, other, 1, "cpu", mode=mode,
                             checkpoint_path=ck, log=logs.append)
    assert ckpt.load(ck)[1:] == (1, 5) and r_c.frames == 1


def test_cli_checkpoint_and_snapshots(tmp_path, capsys):
    """``-F 4`` equals ``-F 2 --checkpoint`` twice, bit for bit;
    ``--snapshot-every 1`` writes the accumulation to ``--out`` each
    frame."""
    base = ["--device", "cpu", "-P", "small", "-W", "16", "-H", "12", "-S",
            "2", "-D", "3"]
    full, part = tmp_path / "full.npy", tmp_path / "part.npy"
    ck = tmp_path / "run.npz"
    assert cli.main(base + ["-F", "4", "--out", str(full)]) == 0
    for _ in range(2):
        assert cli.main(base + ["-F", "2", "--checkpoint", str(ck), "--out",
                                str(part)]) == 0
    log = capsys.readouterr().out
    assert "resumed from" in log
    np.testing.assert_array_equal(np.load(full), np.load(part))
    snap = tmp_path / "snap.npy"
    assert cli.main(base + ["-F", "1", "--snapshot-every", "1", "--out",
                            str(snap)]) == 0
    assert np.load(snap).shape == (12, 16, 3)


def test_train_checkpoint_resume_bit_exact(tmp_path):
    """5 steps equal 2 steps, save, a fresh renderer, load, 3 steps: the
    parameters, Adam's moments and count, and the step, bit for bit; the
    loaded optimizer state keeps torch's dtypes and devices."""
    renderer, state, _, target, key = _trainer()
    for _ in range(5):
        state, _ = renderer.train_step(state, target, key)

    r2, s2, _, _, _ = _trainer()
    for _ in range(2):
        s2, _ = r2.train_step(s2, target, key)
    path = str(tmp_path / "train.npz")
    ckpt.save_train(path, s2, key)
    before = {k: (v.dtype, v.device) for k, v in
              s2.optimizer.state[s2.params[0]].items()}

    r3, template, _, _, _ = _trainer()
    s3, saved_key = ckpt.load_train(path, template)
    assert s3.step == 2 and torch.equal(saved_key, key)
    loaded = s3.optimizer.state[s3.params[0]]
    assert {k: (v.dtype, v.device) for k, v in loaded.items()} == before
    for a, b in zip(_opt_leaves(s2), _opt_leaves(s3)):
        np.testing.assert_array_equal(a, b)
    for _ in range(3):
        s3, _ = r3.train_step(s3, target, saved_key)
    assert s3.step == state.step == 5
    for a, b in zip(_opt_leaves(state), _opt_leaves(s3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_train_rejects_mismatched_template(tmp_path):
    renderer, state, _, target, key = _trainer()
    state, _ = renderer.train_step(state, target, key)
    path = str(tmp_path / "t.npz")
    ckpt.save_train(path, state)
    _, other, _, _, _ = _trainer(tinv.default_trainable)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_train(path, other)
    assert ckpt.try_load_train(str(tmp_path / "none.npz"), other) is None


def test_layout_is_the_reference_flattening():
    """The port's leaf order is ``tree_flatten((params, opt_state, step))``
    of the reference's TrainState under ``optax.adam``, worked out here by
    flattening one whose leaves are told apart by their values."""
    import jax
    import jax.numpy as jnp

    from pathtrace_tpu.models import presets as jpresets
    from pathtrace_tpu.parallel import inverse as jinv
    from pathtrace_tpu.parallel import mesh as pmesh

    jscene, jcam = jpresets.small(1.0)
    jr, jstate, names = jinv.make_inverse_renderer(
        jscene, jcam, W, H, samples=2, max_depth=3,
        mesh=pmesh.make_render_mesh(jax.devices()[:1]),
        trainable=tinv.default_trainable)
    P = len(names)
    adam = jstate.opt_state[0]
    tagged = jinv.TrainState(
        [jnp.full_like(p, 1.0 + i) for i, p in enumerate(jstate.params)],
        (adam._replace(count=jnp.int32(7),
                       mu=[jnp.full_like(p, 100.0 + i)
                           for i, p in enumerate(jstate.params)],
                       nu=[jnp.full_like(p, 200.0 + i)
                           for i, p in enumerate(jstate.params)]),
         *jstate.opt_state[1:]),
        jnp.int32(9))
    flat = jax.tree_util.tree_leaves((tagged.params, tagged.opt_state,
                                      tagged.step))
    expect = ([1.0 + i for i in range(P)] + [7]
              + [100.0 + i for i in range(P)] + [200.0 + i for i in range(P)]
              + [9])
    assert [float(np.asarray(x).ravel()[0]) for x in flat] == expect
    assert flat[P].dtype == np.int32 and flat[-1].dtype == np.int32

    renderer, state, tnames, target, key = _trainer(tinv.default_trainable)
    assert tnames == names
    state, _ = renderer.train_step(state, target, key)
    leaves = ckpt.train_leaves(state)
    assert len(leaves) == len(flat) == 3 * P + 2
    for a, b in zip(leaves, flat):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert int(leaves[P]) == 1 and int(leaves[-1]) == 1
    opt = state.optimizer.state
    for i, p in enumerate(state.params):
        np.testing.assert_array_equal(leaves[P + 1 + i], opt[p]["exp_avg"])
        np.testing.assert_array_equal(leaves[2 * P + 1 + i],
                                      opt[p]["exp_avg_sq"])


def test_reference_checkpoint_resumes_in_the_port():
    """A checkpoint the JAX package wrote after 2 steps loads into the
    port (leaf for leaf, count 2), and 3 more port steps follow JAX's 3:
    the parameters' displacement per leaf to 1e-3 relative L2, Adam's
    moments to 1e-3."""
    renderer, template, names, target, _ = _trainer()
    state, key = ckpt.load_train(JAX_CKPT, template)
    assert state.step == 2 and torch.equal(key, PRNGKey(3))
    with np.load(JAX_CKPT) as z:
        for i, a in enumerate(ckpt.train_leaves(state)):
            np.testing.assert_array_equal(a, z[f"leaf_{i}"])
    start = [p.detach().numpy().copy() for p in state.params]
    for _ in range(3):
        state, _ = renderer.train_step(state, target, key)
    ref = np.load(JAX_RESUME)
    assert state.step == int(ref["step"]) == 5
    P = len(names)
    leaves = ckpt.train_leaves(state)
    for i in range(P):
        err = rel_l2(leaves[i] - start[i], ref[f"leaf_{i}"] - start[i])
        assert err <= 1e-3, (names[i], err)
    assert int(leaves[P]) == int(ref[f"leaf_{P}"]) == 5
    for i in range(P + 1, 3 * P + 1):
        assert rel_l2(leaves[i], ref[f"leaf_{i}"]) <= 1e-3, i


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    import jax

    from pathtrace_tpu.models import presets as jpresets
    from pathtrace_tpu.parallel import inverse as jinv
    from pathtrace_tpu.parallel import mesh as pmesh
    from pathtrace_tpu.utils import checkpoint as jckpt

    renderer, state, names, target, key = _trainer()
    for _ in range(2):
        state, _ = renderer.train_step(state, target, key)
    path = str(tmp_path / "port.npz")
    ckpt.save_train(path, state, key)
    jscene, jcam = jpresets.small(1.0)
    _, jtemplate, jnames = jinv.make_inverse_renderer(
        jscene, jcam, W, H, samples=2, max_depth=3,
        mesh=pmesh.make_render_mesh(jax.devices()[:1]),
        trainable=lambda p: "textures.color" in p)
    assert jnames == names
    jstate, jkey = jckpt.load_train(path, jtemplate)
    assert int(jstate.step) == 2
    np.testing.assert_array_equal(np.asarray(jkey),
                                  np.asarray(jax.random.PRNGKey(3)))
    flat = jax.tree_util.tree_leaves((jstate.params, jstate.opt_state,
                                      jstate.step))
    for a, b in zip(ckpt.train_leaves(state), flat):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


def test_example_resumes_bit_exact(tmp_path, capsys):
    """The example's ``--checkpoint``: 4 steps, or 2 steps and a second run
    to 4 from the checkpoint, write the same image and checkpoint."""
    from pathtrace_tpu_torch.examples import inverse_render

    args = ["--device", "cpu", "--size", "12", "--samples", "2"]
    one, two = tmp_path / "one.npz", tmp_path / "two.npz"
    assert inverse_render.main(args + ["--steps", "4", "--checkpoint",
                                       str(one), "--out",
                                       str(tmp_path / "a.npy")]) == 0
    assert inverse_render.main(args + ["--steps", "2", "--checkpoint",
                                       str(two), "--out",
                                       str(tmp_path / "b.npy")]) == 0
    assert inverse_render.main(args + ["--steps", "4", "--checkpoint",
                                       str(two), "--checkpoint-every", "1",
                                       "--out", str(tmp_path / "b.npy")]) == 0
    assert "resumed from" in capsys.readouterr().out
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"),
                                  np.load(tmp_path / "b.npy"))
    with np.load(one) as a, np.load(two) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    capsys.readouterr()
    assert inverse_render.main(args + ["--steps", "4", "--checkpoint",
                                       str(one), "--geometry", "--out",
                                       str(tmp_path / "c.npy")]) == 2
    assert "leaves" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the fixtures (JAX on the CPU)
# ---------------------------------------------------------------------------

def write_fixtures():
    import jax

    from pathtrace_tpu.models import presets as jpresets
    from pathtrace_tpu.parallel import inverse as jinv
    from pathtrace_tpu.parallel import mesh as pmesh
    from pathtrace_tpu.utils import checkpoint as jckpt

    jscene, jcam = jpresets.small(1.0)
    r, state, _ = jinv.make_inverse_renderer(
        jscene, jcam, W, H, samples=2, max_depth=3,
        mesh=pmesh.make_render_mesh(jax.devices()[:1]), learning_rate=2e-2,
        trainable=lambda p: "textures.color" in p)
    key = jax.random.PRNGKey(3)
    target = r.render(state.params, key)
    state = r.init([p + 0.15 for p in state.params])
    for _ in range(2):
        state, _ = r.train_step(state, target, key)
    jckpt.save_train(JAX_CKPT, state, key)
    for _ in range(3):
        state, _ = r.train_step(state, target, key)
    flat = jax.tree_util.tree_leaves((state.params, state.opt_state,
                                      state.step))
    np.savez(JAX_RESUME, step=np.int64(state.step),
             **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(flat)})
    for path in (JAX_CKPT, JAX_RESUME):
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_fixtures()
