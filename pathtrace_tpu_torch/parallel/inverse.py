"""Differentiable inverse rendering: optimize scene parameters to match a
target image (counterpart of ``pathtrace_tpu/parallel/inverse.py``, one
device).

The forward pass is the differentiable fast trace
(:func:`~pathtrace_tpu_torch.render.frame.render_frame_diff`), the loss is
the image MSE, and gradients flow to the trainable scene leaves through
hit distances (the closest hit's backward kernel, which for moving
spheres also differentiates the centre lerped to each ray's time),
normals, attribute rows and the shading. ``torch.optim.Adam`` with its defaults (betas 0.9,
0.999, eps 1e-8) is ``optax.adam``'s update.

A render is keyed as the reference's is: a Threefry key
(:mod:`pathtrace_tpu_torch.utils.threefry`) gives the bounce seed
``randint(fold_in(key, 7), (), 0, 2^31 - 1)`` and the primary rays from
``split(key)[0]``, so the same key gives the reference's rays and seed.
:meth:`InverseRenderer.step_on` takes given rays and seed instead.

Not ported yet: the multi-device split with its gradient all-reduce, the
silhouette boundary term, the general-integrator fallback and TrainState
checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Tuple

import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.ops.fastpath import diff_supported
from pathtrace_tpu_torch.render.frame import render_frame_diff
from pathtrace_tpu_torch.utils import threefry

_GROUPS = ("spheres", "materials", "textures")


def default_trainable(path: str) -> bool:
    """The reference's default selector (a substring match, so
    ``spheres.center`` also selects ``spheres.center_delta``)."""
    return any(s in path for s in (
        "spheres.center",
        "spheres.radius",
        "textures.color",
        "materials.fuzz",
        "materials.ref_idx",
    ))


def _leaf_paths(scene: Scene) -> List[str]:
    """Dotted leaf names in the reference's flattening order (a leaf that
    is None, as an instance affine of a scene without instances, is none,
    as in the reference's pytree)."""
    paths = [f"{g}.{f.name}" for g in _GROUPS
             for f in dataclasses.fields(getattr(scene, g))
             if getattr(getattr(scene, g), f.name) is not None]
    return paths + ["sky", "use_gradient_sky"]


def _get(scene: Scene, path: str) -> torch.Tensor:
    obj = scene
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def split_scene(scene: Scene,
                trainable: Callable[[str], bool] = default_trainable):
    """Split a scene into (trainable leaves, rebuild, names). The leaves
    are fresh tensors that require grad; ``rebuild(params)`` returns the
    scene with them in place. Names and order equal the reference's."""
    names = [p for p in _leaf_paths(scene) if trainable(p)]
    params = [_get(scene, p).detach().clone().requires_grad_(True)
              for p in names]

    def rebuild(params_list) -> Scene:
        groups = {g: {} for g in _GROUPS}
        top = {}
        for name, val in zip(names, params_list):
            if "." in name:
                g, leaf = name.split(".", 1)
                groups[g][leaf] = val
            else:
                top[name] = val
        kw = {g: dataclasses.replace(getattr(scene, g), **groups[g])
              for g in _GROUPS}
        return dataclasses.replace(scene, **kw, **top)

    return params, rebuild, names


class TrainState(NamedTuple):
    params: List[torch.Tensor]   # the trainable leaves (updated in place)
    optimizer: torch.optim.Optimizer
    step: int


@dataclasses.dataclass(eq=False)
class InverseRenderer:
    """Inverse-rendering problem bound to a camera and film."""

    camera: Camera
    width: int
    height: int
    samples: int
    max_depth: int
    features: SceneFeatures
    rebuild: Callable[[List[torch.Tensor]], Scene]
    learning_rate: float = 2e-2
    param_names: Tuple[str, ...] = ()

    def render(self, params, key: torch.Tensor) -> torch.Tensor:
        """Image [H, W, 3], differentiable in ``params``, keyed as the
        reference's fast-path render: the bounce seed
        ``randint(fold_in(key, 7), (), 0, 2^31 - 1)``, the primary rays
        from ``split(key)[0]``."""
        seed = int(threefry.randint(threefry.fold_in(key, 7), (), 0,
                                    2**31 - 1))
        img, _ = render_frame_diff(
            self.rebuild(params), self.camera, self.width, self.height,
            self.samples, self.max_depth, threefry.split(key)[0], seed,
            self.features)
        return img

    def loss(self, params, target, key: torch.Tensor):
        return torch.mean((self.render(params, key) - target) ** 2)

    def init(self, params) -> TrainState:
        return TrainState(params, torch.optim.Adam(params,
                                                   lr=self.learning_rate), 0)

    def _step(self, state: TrainState, loss_fn):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    def train_step(self, state: TrainState, target: torch.Tensor,
                   key: torch.Tensor):
        """One optimization step: render keyed by ``key``, MSE, backward,
        Adam. Returns (state, loss before the update)."""
        return self._step(
            state, lambda: self.loss(state.params, target, key))

    def step_on(self, state: TrainState, target: torch.Tensor, rays,
                seed: int):
        """:meth:`train_step` on given primary rays (ro, rd [R, 3], time
        [R]) and bounce seed."""
        def loss_fn():
            img, _ = render_frame_diff(
                self.rebuild(state.params), self.camera, self.width,
                self.height, self.samples, self.max_depth, None, seed,
                self.features, rays=rays)
            return torch.mean((img - target) ** 2)

        return self._step(state, loss_fn)


def make_inverse_renderer(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    samples: int = 4,
    max_depth: int = 4,
    device="cuda",
    trainable: Callable[[str], bool] = default_trainable,
    learning_rate: float = 2e-2,
    silhouette: bool = False,
):
    """Build (renderer, initial TrainState, trainable-leaf names) on
    ``device``. Raises ``ValueError`` for what is not ported yet: the
    silhouette term and scenes outside the differentiable path's classes
    (boxes and media among them)."""
    if silhouette:
        raise ValueError("the silhouette boundary term: not ported yet")
    features = SceneFeatures.from_scene(scene)
    diff_supported(features, scene)
    scene = scene.to(device)
    params, rebuild, names = split_scene(scene, trainable)
    renderer = InverseRenderer(
        camera=camera.to(device), width=width, height=height,
        samples=samples, max_depth=max_depth, features=features,
        rebuild=rebuild, learning_rate=learning_rate,
        param_names=tuple(names),
    )
    return renderer, renderer.init(params), names

