"""The trainer's first steps worked out again: the target render, the
image MSE and its gradients per leaf, and Adam, in plain PyTorch.

A step keyed ``key`` renders the primary rays of ``split(key)[0]`` with
the bounce seed ``randint(fold_in(key, 7), 0, 2^31 - 1)``, lanes
``0..R-1``, as the trainer keys a one-shard render. The image is traced
in blocks of rows: each block's share of the loss is back-propagated on
its own and the gradients add up, so the reference fits whatever the film.
Adam is ``torch.optim.Adam``'s rule with its defaults (betas 0.9, 0.999,
eps 1e-8), written out.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import threefry, tracer

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
# leaves the differentiable bounce reads (tracer.bounce); any other leaf
# the trainer holds gets a zero gradient, as the loss does not reach it
DIFF_LEAVES = ("spheres.center", "spheres.radius", "textures.color",
               "materials.fuzz", "materials.ref_idx")


def bounce_seed(key: torch.Tensor) -> int:
    return threefry.randint(threefry.fold_in(key, 7), 0, 2**31 - 1)


def render(A, cam, leaves, film, key, target=None, rows_per_block: int = 0):
    """The step's image [H, W, 3] (no gradient); with ``target``, also
    the MSE, whose gradients are added to the leaves' ``.grad``."""
    W, H, S, depth = film
    kray, _ = threefry.split(key)
    seed = bounce_seed(key)
    dev, dtype = A["sky"].device, A["sky"].dtype
    ro, rd, time = tracer.primary_rays(cam, W, H, S, kray, dev, dtype)
    per_row = W * S
    step = rows_per_block or max(1, (1 << 20) // per_row)
    image = torch.empty((H, W, 3), dtype=dtype, device=dev)
    loss = 0.0
    n_out = H * W * 3
    for r0 in range(0, H, step):
        r1 = min(H, r0 + step)
        sl = slice(r0 * per_row, r1 * per_row)
        lane = torch.arange(sl.start, sl.stop, device=dev)
        with torch.set_grad_enabled(target is not None):
            rad = tracer.trace(A, ro[sl], rd[sl], time[sl], lane, seed, depth,
                               leaves=leaves)
            img = rad.reshape(r1 - r0, W, S, 3).mean(dim=2)
            if target is not None:
                part = ((img - target[r0:r1]) ** 2).sum() / n_out
                part.backward()
                loss += float(part.detach())
        image[r0:r1] = img.detach()
    return image, loss


def init_leaves(A, names: List[str], overrides: Dict[str, torch.Tensor]):
    """The leaves the trainer holds, by name, from the scene's arrays (the
    benchmark's perturbed values in ``overrides``), as fresh tensors."""
    source = {"spheres.center": A["sp_center"], "spheres.radius": A["sp_radius"],
              "textures.color": A["tex_color"], "materials.fuzz": A["mat_fuzz"],
              "materials.ref_idx": A["mat_ref_idx"]}
    out = {}
    for n in names:
        base = overrides.get(n, source.get(n))
        if base is None:
            base = A["sp_delta"] if n == "spheres.center_delta" else None
        if base is None:
            raise ValueError(f"reference: no leaf {n!r}")
        out[n] = base.detach().clone().requires_grad_(n in DIFF_LEAVES)
    return out


def adam(leaves, grads, m, v, t: int, lr: float):
    for n, p in leaves.items():
        g = grads[n]
        m[n] = BETA1 * m[n] + (1.0 - BETA1) * g
        v[n] = BETA2 * v[n] + (1.0 - BETA2) * g * g
        bc1 = 1.0 - BETA1 ** t
        bc2 = 1.0 - BETA2 ** t
        denom = v[n].sqrt() / (bc2 ** 0.5) + EPS
        with torch.no_grad():
            p -= (lr / bc1) * m[n] / denom


def run_steps(A_true, cam, film, names, overrides, target_key, step_keys,
              lr: float) -> Tuple[List[float], Dict, Dict]:
    """The target from the true scene, then ``len(step_keys)`` Adam steps
    from the perturbed leaves: (losses, first gradients by leaf, the
    leaves' change after the last step by leaf)."""
    with torch.no_grad():
        target, _ = render(A_true, cam, None, film, target_key)
    leaves = init_leaves(A_true, names, overrides)
    start = {n: p.detach().clone() for n, p in leaves.items()}
    m = {n: torch.zeros_like(p) for n, p in leaves.items()}
    v = {n: torch.zeros_like(p) for n, p in leaves.items()}
    losses, first = [], None
    for t, key in enumerate(step_keys, start=1):
        for p in leaves.values():
            p.grad = None
        _, loss = render(A_true, cam, {n: p for n, p in leaves.items()
                                       if n in DIFF_LEAVES}, film, key,
                         target=target)
        grads = {n: (p.grad.detach().clone() if p.grad is not None
                     else torch.zeros_like(p)) for n, p in leaves.items()}
        if first is None:
            first = grads
        losses.append(loss)
        adam(leaves, grads, m, v, t, lr)
    change = {n: (p.detach() - start[n]) for n, p in leaves.items()}
    return losses, first, change
