"""Two-process ``torch.distributed`` validation of the port's render mesh
(twin of tests/test_distributed.py).

Runs ``python -m pathtrace_tpu_torch.tools.distributed_smoke``: 2 OS
processes x 4 virtual CPU shards joined through the CLI's
``--distributed`` path (torchrun's environment, gloo), a sharded
differentiable render and the cross-process gradient all-reduce; both
processes must agree bit for bit and equal a one-process 8-shard run
(rtol 1e-4 / atol 1e-6, the reference tool's bounds), which a gradient
all-reduced once too often (world size times too large) fails. The
loss and gradient also hold the JAX package's 8-device computation of
its own tool (``tests/goldens/torch_port_sharded.npz``) within
``GRAD_TOL``. A second run drives the CLI itself: ``--distributed
--mode sharded`` in two processes renders the one-process image bit for
bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from torch_port_util import GRAD_TOL, rel_l2  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "torch_port_sharded.npz")

pytestmark = pytest.mark.skipif(
    not (dist.is_available() and dist.is_gloo_available()),
    reason="torch.distributed has no gloo backend here")


def _smoke(what, out_dir):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "pathtrace_tpu_torch.tools.distributed_smoke",
         "--what", what, "--out-dir", str(out_dir)],
        cwd=ROOT, capture_output=True, timeout=120, env=env)
    out = proc.stdout.decode()
    assert proc.returncode == 0, out + proc.stderr.decode()
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def test_two_process_gradient_allreduce(tmp_path):
    rep = _smoke("grad", tmp_path)
    assert rep["pass"], rep
    assert rep["procs_bitwise_equal"] and rep["grad_matches_single"]
    assert rep["saw_8_shards"] and rep["saw_2_processes"]
    ref = np.load(FIXTURE)
    got = np.load(tmp_path / "p0.npz")
    assert abs(float(got["loss"]) - float(ref["smoke.loss"])) <= \
        1e-3 * abs(float(ref["smoke.loss"]))
    err = rel_l2(got["grad"], ref["smoke.grad"])
    assert err <= GRAD_TOL["textures.color"], err
    # the general shards' draws are JAX's lane for lane: a path that
    # diverged may be up to DEPTH + 1 segments longer or shorter
    assert abs(int(got["ray_count"]) - int(ref["smoke.ray_count"])) <= \
        0.005 * 1024 * 5


def test_two_process_cli_renders_the_one_process_image(tmp_path):
    rep = _smoke("cli", tmp_path)
    assert rep["pass"], rep
    assert rep["rank0_wrote_alone"] and rep["image_bitwise_equal"]
    assert np.isfinite(np.load(tmp_path / "cli_2proc.npy")).all()
