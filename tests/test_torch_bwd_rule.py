"""K6's launch rule and its input layout, on the CPU.

K6 (``csrc/sphere_nearest_bwd.cu``) takes its grid and its instance from
``intersect_kernel.bwd_launch``: a block of 256 threads per 1024 rays
(four a thread); per-block sums in shared memory while they fit in the
227 KB a block may opt into, else added straight into device memory. It
moves rays as float4s, so the wrapper hands it every per-ray array on a
16-byte boundary (``intersect_kernel._aligned``). The plain version, which the wrapper runs
on the CPU, is held to JAX in ``tests/test_torch_grad.py`` and
``tests/test_torch_motion.py``; here its per-ray gradients do not depend
on the layout of their inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pathtrace_tpu_torch.models import presets  # noqa: E402
from pathtrace_tpu_torch.ops import intersect_kernel as ik  # noqa: E402

R_FULL = 1280 * 720 * 4


@pytest.mark.parametrize("n_rays,blocks", [
    (1, 1), (4, 1), (1024, 1), (1025, 2), (65_536, 64), (262_144, 256),
    (R_FULL, 3600),
])
def test_a_block_per_1024_rays(n_rays, blocks):
    """256 threads of 4 rays a block, whatever the spheres."""
    for n_spheres, moving in ((512, False), (512, True), (20_000, False)):
        assert ik.bwd_launch(n_rays, n_spheres, moving)[0] == blocks


@pytest.mark.parametrize("n_spheres,moving,shared", [
    (512, False, True),
    (3072, False, True),        # 48 KB: no opt-in needed
    (14_528, False, True),      # 232,448 bytes: the opt-in limit
    (14_529, False, False),     # into device memory
    (1365, True, True),
    (6456, True, True),
    (6457, True, False),
])
def test_instance_at_its_edges(n_spheres, moving, shared, monkeypatch):
    assert ik.bwd_launch(R_FULL, n_spheres, moving)[1] == shared
    # the limit is read at the call (the bench lowers it to time the
    # device-memory instance): a lower one moves the edge
    monkeypatch.setattr(ik, "BWD_SHARED_BYTES", 48 * 1024)
    assert ik.bwd_launch(R_FULL, n_spheres, moving)[1] == (
        (9 if moving else 4) * 4 * n_spheres <= 48 * 1024)


def test_aligned_copies_only_a_view_off_16_bytes():
    base = torch.arange(40, dtype=torch.float32)
    assert ik._aligned(base).data_ptr() == base.data_ptr()
    view = base[1:]
    assert view.data_ptr() % 16 != 0
    got = ik._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    rows = base.reshape(10, 4)[:, :3]  # not contiguous: made so, aligned
    got = ik._aligned(rows)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, rows)


@pytest.mark.parametrize("moving", [False, True])
def test_plain_gradients_do_not_depend_on_the_input_layout(moving):
    """The wrapper's plain version gives the same bits from views off a
    16-byte boundary as from fresh tensors (what the kernel is handed after
    ``_aligned``), g_time included."""
    scene = presets.from_name("random" if moving else "random_spheres",
                              16 / 9)[0]
    sp = scene.spheres
    rng = np.random.default_rng(5)
    n = 1001
    m = n + 1
    idx = rng.integers(0, 488, m).astype(np.int32)
    c = sp.center.numpy()[idx]
    u = rng.normal(size=(m, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = (c + 3.0 * np.abs(sp.radius.numpy()[idx])[:, None] * u).astype(
        np.float32)
    per_ray = [torch.from_numpy(x) for x in (
        o, -u, np.ones(m, np.float32), idx,
        rng.uniform(0.5, 1.5, m).astype(np.float32),
        rng.random(m).astype(np.float32))]
    views = [x[1:] for x in per_ray]
    fresh = [x.clone() for x in views]
    out = []
    for ro, rd, t, ix, g_t, tm in (views, fresh):
        motion = ((sp.center_delta, sp.time0, sp.inv_time_delta, tm)
                  if moving else None)
        out.append(ik.sphere_nearest_bwd(sp.center, sp.radius, ro, rd, t, ix,
                                         g_t, motion=motion))
    for a, b in zip(*out):
        assert torch.equal(a, b)
