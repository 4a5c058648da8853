"""Render and TrainState checkpoints (counterpart of
``pathtrace_tpu/utils/checkpoint.py``), in its ``.npz`` layouts, so that
each package loads the other's files.

A render's whole state is (accumulation buffer, frame_num, seed): frame
``n`` is keyed ``fold_in(PRNGKey(seed), n)``, so a resumed render equals
an uninterrupted one bit for bit.

A TrainState is saved as the reference flattens ``(params, opt_state,
step)`` under ``optax.adam``: ``leaf_0`` .. ``leaf_{P-1}`` the trainable
leaves, then Adam's ``count`` (int32), its first moments ``mu`` (P
leaves), its second moments ``nu`` (P leaves) and the step (int32), with
``n_leaves`` and the Threefry key ``rng_key`` (uint32 [2]). torch's Adam
state maps onto it: ``exp_avg`` is ``mu``, ``exp_avg_sq`` is ``nu`` and
``state["step"]`` (a float32 scalar on the host) is ``count``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def save(path: str, acc_image, frame_num: int, seed: int) -> None:
    """Save a progressive render's state."""
    if isinstance(acc_image, torch.Tensor):
        acc_image = acc_image.detach().cpu().numpy()
    np.savez(path, acc_image=np.asarray(acc_image, np.float32),
             frame_num=np.int64(frame_num), seed=np.int64(seed))


def load(path: str) -> Tuple[np.ndarray, int, int]:
    """(acc_image [H, W, 3] float32, frame_num, seed)."""
    with np.load(path) as z:
        return z["acc_image"], int(z["frame_num"]), int(z["seed"])


def try_load(path: Optional[str]):
    """:func:`load`, or None when ``path`` is empty or not a file."""
    if not path:
        return None
    try:
        return load(path)
    except (FileNotFoundError, OSError):
        return None


def train_leaves(state) -> List[np.ndarray]:
    """The reference's flattening of a TrainState (numpy): params, Adam's
    count, ``mu``, ``nu``, step. A parameter Adam has not stepped yet has
    zero moments, as ``optax.adam``'s ``init`` gives them."""
    params = [p.detach().cpu().numpy() for p in state.params]
    opt_state = [state.optimizer.state.get(p, {}) for p in state.params]
    counts = {int(s["step"]) for s in opt_state if "step" in s}
    if len(counts) > 1:
        raise ValueError(f"parameters with different Adam counts: {counts}")
    count = counts.pop() if counts else 0

    def moment(name):
        return [s[name].detach().cpu().numpy() if name in s
                else np.zeros_like(p) for s, p in zip(opt_state, params)]

    return (params + [np.int32(count)] + moment("exp_avg")
            + moment("exp_avg_sq") + [np.int32(state.step)])


def save_train(path: str, state, key: Optional[torch.Tensor] = None) -> None:
    """Save a TrainState (and the Threefry key) to ``path`` (.npz)."""
    flat = train_leaves(state)
    arrs = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(flat)}
    arrs["n_leaves"] = np.int64(len(flat))
    if key is not None:
        arrs["rng_key"] = np.asarray(key.cpu().numpy(), np.uint32)
    np.savez(path, **arrs)


def load_train(path: str, template_state):
    """Load a TrainState saved by either package into ``template_state``
    (the output of ``renderer.init``, which supplies the parameters, their
    device and the optimizer): the parameters are overwritten in place and
    the optimizer's state is set through ``load_state_dict``, ``step`` a
    float32 host scalar as torch's Adam keeps it. Returns ``(state,
    key_or_None)``; raises ``ValueError`` when the file's leaves do not
    match the template's."""
    from pathtrace_tpu_torch.parallel.inverse import TrainState

    with np.load(path) as z:
        n = int(z["n_leaves"])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        key = (torch.from_numpy(z["rng_key"].astype(np.int64))
               if "rng_key" in z.files else None)
    params = template_state.params
    P = len(params)
    if n != 3 * P + 2:
        raise ValueError(
            f"checkpoint has {n} leaves but the template state has "
            f"{3 * P + 2}: renderer/optimizer configuration mismatch")
    values, count = leaves[:P], int(leaves[P])
    mu, nu = leaves[P + 1:2 * P + 1], leaves[2 * P + 1:3 * P + 1]
    for p, v, m, s in zip(params, values, mu, nu):
        if not (v.shape == m.shape == s.shape == tuple(p.shape)):
            raise ValueError(f"checkpoint leaf of shape {v.shape} for a "
                             f"parameter of shape {tuple(p.shape)}")
    with torch.no_grad():
        for p, v in zip(params, values):
            p.copy_(torch.from_numpy(np.ascontiguousarray(v)).to(p.device))
    opt = template_state.optimizer
    sd = opt.state_dict()
    sd["state"] = {} if count == 0 else {
        i: {"step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.ascontiguousarray(m)),
            "exp_avg_sq": torch.from_numpy(np.ascontiguousarray(s))}
        for i, (m, s) in enumerate(zip(mu, nu))}
    opt.load_state_dict(sd)
    return TrainState(params, opt, int(leaves[3 * P + 1])), key


def try_load_train(path: Optional[str], template_state):
    """:func:`load_train`, or None when ``path`` is empty or not a file."""
    if not path:
        return None
    try:
        return load_train(path, template_state)
    except (FileNotFoundError, OSError):
        return None
