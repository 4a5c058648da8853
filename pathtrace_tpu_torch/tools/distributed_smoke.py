"""Two-process ``torch.distributed`` check of the render mesh on the CPU
(twin of the repository's ``tools/distributed_smoke.py``).

``--what grad`` (default) runs the path of the CLI's ``--distributed``
flag (:func:`~pathtrace_tpu_torch.parallel.mesh.init_distributed` from
torchrun's environment, gloo) in two OS processes with 4 virtual CPU
shards each: a differentiable general-mode ``trace_sharded`` of R = 1024
rays of ``small`` at depth 4, the loss ``mean(radiance)`` over the whole
wavefront, its gradient in the texture colours, and the gradients'
all-reduce (``mesh.all_reduce_grads``). It checks that

1. both processes hold the same loss, gradient and ray count, bit for
   bit;
2. they equal a one-process run over 8 virtual shards (the same global
   shards, so the same draws), the loss to rtol 1e-5 / atol 1e-6 and the
   gradient to rtol 1e-4 / atol 1e-6 as the reference's tool holds them:
   the all-reduce sums in another order, and a gradient counted once per
   process (world-size times too large) fails.

``--what cli`` runs ``python -m pathtrace_tpu_torch --distributed --device
cpu --mode sharded`` in two processes and the same command without
``--distributed`` in one, and checks that rank 0 alone wrote the image
and that it equals the one-process image bit for bit (fast shards key on
global lane ids), with the same ray count.

Usage:
  python -m pathtrace_tpu_torch.tools.distributed_smoke [--what grad|cli] [--out-dir DIR]
  python -m pathtrace_tpu_torch.tools.distributed_smoke --worker --out OUT.npz   # one rank, under torchrun's environment
Prints one JSON line; exit 0 on pass, 1 on fail, 3 when gloo is not
available.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

R = 1024
DEPTH = 4
LOCAL_SHARDS = 4
PROCESSES = 2
ROOT = Path(__file__).resolve().parents[2]
CLI_ARGS = ["-P", "small", "-W", "24", "-H", "12", "-S", "2", "-D", "4",
            "-O", "-F", "2", "--device", "cpu", "--mode", "sharded"]


def compute(out_path: str, mesh) -> None:
    """The differentiable sharded trace and its all-reduced gradient over
    ``mesh``; writes loss, ray count, gradient and the mesh's shape."""
    import torch

    from pathtrace_tpu_torch.camera import get_rays
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.parallel import mesh as pmesh
    from pathtrace_tpu_torch.parallel.inverse import split_scene
    from pathtrace_tpu_torch.utils import threefry

    scene, cam = presets.small(1.0)
    feats = SceneFeatures.from_scene(scene)
    # the reference tool's rays, identical on every process
    key = threefry.PRNGKey(0)
    s = threefry.uniform(threefry.fold_in(key, 0), (R,))
    t = threefry.uniform(threefry.fold_in(key, 1), (R,))
    u = threefry.uniform(threefry.fold_in(key, 2), (R, 3))
    ro, rd, tm = get_rays(cam, s, t, u)
    params, rebuild, _ = split_scene(scene, lambda p: p == "textures.color")
    rad, cnt = pmesh.trace_sharded(rebuild(params), ro, rd, tm,
                                   threefry.PRNGKey(7), DEPTH, mesh,
                                   features=feats, differentiable=True)
    loss = rad.mean()
    loss.backward()
    pmesh.all_reduce_grads(params, mesh)
    np.savez(out_path, loss=loss.detach().numpy(), ray_count=int(cnt),
             grad=params[0].grad.numpy(), n_shards=mesh.size,
             n_processes=mesh.world)


def worker(out_path: str) -> int:
    import torch

    from pathtrace_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(2)
    pmesh.init_distributed("cpu")
    try:
        compute(out_path, pmesh.make_render_mesh(["cpu"] * LOCAL_SHARDS))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def _env(rank: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(PROCESSES), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]))
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argv_of_rank):
    """Start one process a rank under torchrun's environment."""
    port = _free_port()
    return [subprocess.Popen([sys.executable] + argv_of_rank(i), cwd=ROOT,
                             env=_env(i, port), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for i in range(PROCESSES)]


def _wait(procs):
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=100)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    return [p.returncode for p in procs], logs


def _report(checks: dict, what: str, **extra) -> int:
    ok = all(checks.values())
    print(json.dumps({"bench": "distributed_smoke", "what": what, "pass": ok,
                      **checks, **extra}))
    return 0 if ok else 1


def run_grad(out_dir: str) -> int:
    import torch

    from pathtrace_tpu_torch.parallel import mesh as pmesh

    outs = [os.path.join(out_dir, f"p{i}.npz") for i in range(PROCESSES)]
    procs = _launch(lambda i: ["-m", "pathtrace_tpu_torch.tools."
                               "distributed_smoke", "--worker", "--out",
                               outs[i]])
    # the one-process run over the same 8 global shards, meanwhile
    single = os.path.join(out_dir, "single.npz")
    torch.set_num_threads(2)
    compute(single, pmesh.make_render_mesh(["cpu"] * LOCAL_SHARDS * PROCESSES))
    rcs, logs = _wait(procs)
    if any(rcs):
        return _report({"workers_ran": False}, "grad", rcs=rcs,
                       reason="\n".join(logs)[-800:])
    a, b, r = (np.load(p) for p in (*outs, single))
    checks = {
        "procs_bitwise_equal": bool(
            np.array_equal(a["loss"], b["loss"])
            and np.array_equal(a["grad"], b["grad"])
            and a["ray_count"] == b["ray_count"]),
        "loss_matches_single": bool(
            np.allclose(a["loss"], r["loss"], rtol=1e-5, atol=1e-6)),
        "grad_matches_single": bool(
            np.allclose(a["grad"], r["grad"], rtol=1e-4, atol=1e-6)),
        "ray_count_matches": bool(a["ray_count"] == r["ray_count"]),
        "saw_8_shards": int(a["n_shards"]) == int(r["n_shards"]) == 8,
        "saw_2_processes": int(a["n_processes"]) == PROCESSES,
    }
    return _report(checks, "grad", loss=float(a["loss"]),
                   ray_count=int(a["ray_count"]),
                   grad_max_abs_diff=float(np.abs(a["grad"] - r["grad"]).max()))


def run_cli(out_dir: str) -> int:
    import contextlib
    import io

    from pathtrace_tpu_torch import cli

    multi = os.path.join(out_dir, "cli_2proc.npy")
    procs = _launch(lambda i: ["-m", "pathtrace_tpu_torch", "--distributed"]
                    + CLI_ARGS + ["--out", multi])
    single = os.path.join(out_dir, "cli_1proc.npy")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc1 = cli.main(CLI_ARGS + ["--out", single])
    rcs, logs = _wait(procs)

    def rays(text):
        m = re.search(r"secs (\d+)rays", text)
        return int(m.group(1)) if m else None

    checks = {
        "ran": rc1 == 0 and not any(rcs),
        "two_process_mesh": all("mesh: 2 shard(s) (2 process(es) x 1" in t
                                for t in logs),
        "rank0_wrote_alone": ("wrote " in logs[0]
                              and "wrote " not in logs[1]),
        "image_bitwise_equal": bool(
            os.path.exists(multi) and os.path.exists(single)
            and np.array_equal(np.load(multi), np.load(single))),
        "ray_count_matches": (rays(logs[0]) == rays(logs[1])
                              == rays(buf.getvalue()) is not None),
    }
    return _report(checks, "cli", rcs=rcs, rays=rays(buf.getvalue()),
                   **({} if all(checks.values())
                      else {"reason": "\n".join(logs)[-800:]}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtrace_tpu_torch.tools.distributed_smoke")
    ap.add_argument("--what", choices=("grad", "cli"), default="grad")
    ap.add_argument("--out-dir", default=None,
                    help="keep the processes' outputs here (default: a "
                         "temporary directory)")
    ap.add_argument("--worker", action="store_true",
                    help="one rank of --what grad, under torchrun's "
                         "environment")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.out)
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_gloo_available()):
        print(json.dumps({"bench": "distributed_smoke", "skipped": True,
                          "reason": "gloo is not available"}))
        return 3
    run = run_grad if args.what == "grad" else run_cli
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        return run(args.out_dir)
    with tempfile.TemporaryDirectory(prefix="ptpu_torch_dist_") as out_dir:
        return run(out_dir)


if __name__ == "__main__":
    sys.exit(main())
