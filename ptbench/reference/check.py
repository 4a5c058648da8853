"""The numbers that decide ``correct``: the program's outputs against the
reference's, each a gap that a sound run keeps small.

Frames: ``pixels_off_pct``, the share of the checked pixels whose colour
differs from the reference's by more than 1e-3 (relative above 1) in any
channel, or is not finite. A path flips where a float32 rounding sends a
ray the other way, so a sound frame differs on a few per cent of pixels;
a frame computed in a lower precision, or whose rays, samples, keys or
accumulation are wrong, differs on most.

Train steps: ``loss_gap`` (the largest relative gap of the checked
steps' losses), ``grad_gap`` (the first step's gradient, by the worst
leaf: the gap between the two norms over the larger of the reference's
norm of that leaf and of the median leaf) and ``change_gap`` (the same of
the leaves' change over the checked steps), the last over the leaves
whose reference gradient is at least a thousandth of the median leaf's.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

PIXEL_TOL = 1e-3
LEAF_FLOOR = 1e-3  # leaves whose gradient is under this share of the median


def frame_from_acc(prev: torch.Tensor, acc: torch.Tensor, frame_num: int):
    """Frame ``frame_num``'s own image from the accumulation before and
    after it (``acc = prev * n/(n+1) + new / (n+1)``), in float64."""
    n = float(frame_num)
    mix = n / (n + 1.0)
    return (acc.double() - prev.double() * mix) / (1.0 - mix)


def pixels_off_pct(image: torch.Tensor, ref: torch.Tensor) -> float:
    image, ref = image.double(), ref.double()
    gap = (image - ref).abs()
    tol = PIXEL_TOL * torch.clamp(ref.abs(), min=1.0)
    off = ~(gap <= tol).all(dim=-1)
    return 100.0 * float(off.double().mean())


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(x.double().norm()) for n, x in d.items()}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: List[str]) -> float:
    """The worst leaf's gap between the program's and the reference's
    norms, over the larger of the reference's norm and the median leaf's."""
    p, r = _norms(prog), _norms(ref)
    med = statistics.median(r[n] for n in leaves)
    return max(abs(p[n] - r[n]) / max(r[n], med, 1e-30) for n in leaves)


def counted_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(ref_grad)
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= LEAF_FLOOR * med]


def train_numbers(prog_losses, ref_losses, prog_grad, ref_grad, prog_change,
                  ref_change) -> Dict[str, float]:
    leaves = counted_leaves(ref_grad)
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(prog_losses, ref_losses)),
        "grad_gap": leaf_gap(prog_grad, ref_grad, leaves),
        "change_gap": leaf_gap(prog_change, ref_change, leaves),
    }
