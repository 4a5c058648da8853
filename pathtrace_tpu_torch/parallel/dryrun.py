"""One training step over an n-shard mesh (twin of
``__graft_entry__.dryrun_multichip``, ``__graft_entry__.py:36-91``).

The step is the trainer's: a differentiable frame split over the mesh
(rays data-parallel, the scene replicated), the MSE against a black
target, the scene gradients summed over the shards, and an Adam update,
on ``presets.small`` at 16x16, 2 spp, depth 3, training the texture
colours and the sphere centres. It checks that the loss is finite and
that the parameters moved:

    python -m pathtrace_tpu_torch.parallel.dryrun 4              # 4 cards
    python -m pathtrace_tpu_torch.parallel.dryrun 8 --device cpu # 8 virtual CPU shards
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> dict:
    """One step over ``n_devices`` shards: the first ``n_devices`` visible
    cards, or with ``device`` that many virtual shards on it. Raises if
    there are fewer cards, if the loss is not finite or if no parameter
    moved. Returns the loss, the trainable names and the step."""
    import torch

    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.parallel import mesh as pmesh
    from pathtrace_tpu_torch.parallel.inverse import make_inverse_renderer
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    if device is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n_devices:
            raise AssertionError(f"need {n_devices} devices, have {visible}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [torch.device(device)] * n_devices
    mesh = pmesh.make_render_mesh(devices)
    width = height = 16
    scene, camera = presets.small(1.0)
    renderer, state, names = make_inverse_renderer(
        scene, camera, width, height, samples=2, max_depth=3, mesh=mesh,
        trainable=lambda p: "textures.color" in p or "spheres.center" in p)
    target = torch.zeros((height, width, 3), device=mesh.home)
    before = [p.detach().clone() for p in state.params]
    state, loss = renderer.train_step(state, target, PRNGKey(0))
    loss = float(loss)
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"non-finite loss {loss}")
    if not any(bool((p.detach() != b).any())
               for p, b in zip(state.params, before)):
        raise AssertionError("train step applied no parameter update")
    print(f"dryrun_multichip({n_devices}): loss={loss:.6f}, "
          f"trainable={names}, step={state.step}")
    return {"loss": loss, "names": names, "step": state.step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtrace_tpu_torch.parallel.dryrun")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None,
                    help="virtual shards on this device (default: one card "
                         "a shard)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
