"""Differentiable inverse rendering: optimize scene parameters to match a
target image, data-parallel over a render mesh (counterpart of
``pathtrace_tpu/parallel/inverse.py``).

The forward pass is the mesh's differentiable frame
(:func:`~pathtrace_tpu_torch.parallel.mesh.render_frame_sharded`): the
fast trace (``trace_fast_diff`` in every shard) on the scenes it takes,
else the general integrator's ``trace_diff``, as the reference routes
them (``use_fast_path=None``). The loss is the MSE over the whole image,
which every rank holds, and gradients flow to
the trainable scene leaves through hit distances (the closest hit's
backward kernel, which for moving spheres also differentiates the centre
lerped to each ray's time), normals, attribute rows and the shading. With
``silhouette`` the visibility boundary term
(:func:`~pathtrace_tpu_torch.ops.silhouette.silhouette_grads_all`) is
added to each named leaf's gradient after the backward and before the
update, from the forward image the loss already computed.
``torch.optim.Adam`` with its defaults (betas 0.9, 0.999, eps 1e-8) is
``optax.adam``'s update.

Gradients across shards: within a process autograd sums the shards'
contributions through the replicated leaves; across the processes of
the mesh's group each trainable leaf's gradient is ``all_reduce``d (SUM)
once, after the backward and before the silhouette term and Adam. Each
rank's backward reaches only its own shards (the gathered rows of the
others carry no gradient), so the sum is the gradient of the one global
loss. The silhouette term runs on the whole forward image, the same on
every rank, and is added after the all-reduce.

A render is keyed as the reference's is: a Threefry key
(:mod:`pathtrace_tpu_torch.utils.threefry`) gives the fast path's bounce
seed ``randint(fold_in(key, 7), (), 0, 2^31 - 1)`` (unfolded, as the
reference's traced seed) and the primary rays from ``split(key)[0]``, the
general path the rays of ``split(key)[0]`` and shard ``s``'s bounces
``fold_in(split(key)[1], s)``, and the silhouette term ``fold_in(key,
0x51)``, so the same key gives the reference's draws on a mesh of the
same size. :meth:`InverseRenderer.step_on` takes given rays and seed
instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.models.types import Scene, SceneFeatures
from pathtrace_tpu_torch.ops.fastpath import diff_refusal, diff_supported
from pathtrace_tpu_torch.parallel import mesh as pmesh
from pathtrace_tpu_torch.utils import threefry

# the scene's leaf groups in the reference's flattening order
_GROUPS = ("spheres", "rects", "boxes", "media", "materials", "textures",
           "perlin", "atlas")


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
              for g in _GROUPS if groups[g]}
        return dataclasses.replace(scene, **kw, **top)

    return params, rebuild, names


class TrainState(NamedTuple):
    params: List[torch.Tensor]   # the trainable leaves (updated in place)
    optimizer: torch.optim.Optimizer
    step: int


@dataclasses.dataclass(eq=False)
class InverseRenderer:
    """Inverse-rendering problem bound to a camera, film and mesh."""

    camera: Camera
    width: int
    height: int
    samples: int
    max_depth: int
    mesh: pmesh.RenderMesh
    features: SceneFeatures
    rebuild: Callable[[List[torch.Tensor]], Scene]
    learning_rate: float = 2e-2
    use_fast_path: bool = True
    # the visibility boundary term (ops/silhouette.py) for sphere, rect and
    # box geometry: interior autodiff alone sees no gradient from pure
    # occlusion changes
    silhouette: bool = False
    silhouette_samples: int = 128
    param_names: Tuple[str, ...] = ()

    def render(self, params, key: torch.Tensor) -> torch.Tensor:
        """Image [H, W, 3] on ``mesh.home``, differentiable in ``params``
        through this rank's shards, keyed as the reference's render on a
        mesh of the same size: on the fast path the bounce seed
        ``randint(fold_in(key, 7), (), 0, 2^31 - 1)`` (a tensor, so not
        folded) and the primary rays from ``split(key)[0]``; on the
        general path shard ``s``'s bounces ``fold_in(split(key)[1], s)``."""
        scene = self.rebuild(params)
        if self.use_fast_path:
            seed = threefry.randint(threefry.fold_in(key, 7), (), 0,
                                    2**31 - 1)
            img, _ = pmesh.render_frame_sharded(
                scene, self.camera, self.width, self.height, self.samples,
                self.max_depth, key, self.mesh, features=self.features,
                differentiable=True, mode="fast", seed=seed)
            return img
        img, _ = pmesh.render_frame_sharded(
            scene, self.camera, self.width, self.height, self.samples,
            self.max_depth, key, self.mesh, features=self.features,
            differentiable=True)
        return img

    def loss(self, params, target, key: torch.Tensor):
        return torch.mean((self.render(params, key) - target) ** 2)

    def init(self, params) -> TrainState:
        return TrainState(params, torch.optim.Adam(params,
                                                   lr=self.learning_rate), 0)

    def _step(self, state: TrainState, target, image_fn, key=None):
        """zero_grad, forward, MSE, backward, the gradients'
        all-reduce across the mesh's processes, then the silhouette term
        (keyed ``fold_in(key, 0x51)``) and Adam. A leaf the loss does not
        reach gets a zero gradient, as ``jax.grad`` gives it, so Adam
        updates its moments and count as optax does."""
        state.optimizer.zero_grad(set_to_none=True)
        img = image_fn()
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        for p in state.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        pmesh.all_reduce_grads(state.params, self.mesh)
        if self.silhouette:
            self._add_silhouette_grads(state.params, target, key,
                                       img.detach())
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    def train_step(self, state: TrainState, target: torch.Tensor,
                   key: torch.Tensor):
        """One optimization step: render keyed by ``key``, MSE, backward,
        the silhouette term when on, Adam. Returns (state, loss before the
        update)."""
        return self._step(state, target,
                          lambda: self.render(state.params, key), key)

    def step_on(self, state: TrainState, target: torch.Tensor, rays,
                seed: int):
        """:meth:`train_step` on the fast path with given primary rays
        (ro, rd [R, 3], time [R], in [H, W, S] order) and bounce seed,
        split over the mesh; the silhouette term, which needs the step's
        key, is refused."""
        if self.silhouette or not self.use_fast_path:
            raise ValueError("step_on: the fast path without the silhouette "
                             "term only (train_step keys the others)")

        def image():
            radiance, _ = pmesh.trace_padded(
                self.rebuild(state.params), *rays, None, self.max_depth,
                self.mesh, features=self.features, differentiable=True,
                mode="fast", seed=seed)
            return radiance.reshape(self.height, self.width, self.samples,
                                    3).mean(dim=2)

        return self._step(state, target, image)

    def silhouette_terms(self, params, target, key: torch.Tensor,
                         img: torch.Tensor):
        """The boundary terms of the step keyed ``key`` whose forward image
        is ``img``: ``grad_img = 2 (img - target) / img.numel()`` through
        ``silhouette_grads_all`` at ``fold_in(key, 0x51)``, a dict by
        leaf name."""
        from pathtrace_tpu_torch.ops.silhouette import silhouette_grads_all

        with torch.no_grad():
            scene = self.rebuild([p.detach() for p in params])
            grad_img = 2.0 * (img - target) / img.numel()
            return silhouette_grads_all(
                scene, self.camera, self.width, self.height, grad_img,
                threefry.fold_in(key, 0x51), max_depth=self.max_depth,
                features=self.features, n_samples=self.silhouette_samples)

    def _add_silhouette_grads(self, params, target, key, img) -> None:
        terms = self.silhouette_terms(params, target, key, img)
        with torch.no_grad():
            for p, name in zip(params, self.param_names):
                if name in terms:
                    p.grad = p.grad + terms[name]


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
    use_fast_path: Optional[bool] = None,
    silhouette: bool = False,
    silhouette_samples: int = 128,
    mesh: Optional[pmesh.RenderMesh] = None,
):
    """Build (renderer, initial TrainState, trainable-leaf names) over
    ``mesh`` (:func:`~pathtrace_tpu_torch.parallel.mesh.make_render_mesh`;
    default: one shard on ``device``), with the scene, camera and
    parameters on ``mesh.home``. ``use_fast_path=None`` (auto) trains on
    the differentiable
    fast path whenever it takes the scene (:func:`~pathtrace_tpu_torch.ops.fastpath.diff_refusal`),
    and through the general integrator otherwise (instances, more than
    128 rects, checkers with non-constant children); ``True`` raises
    ``ValueError`` for a scene the fast path refuses."""
    features = SceneFeatures.from_scene(scene)
    if use_fast_path is None:
        use_fast_path = diff_refusal(features, scene) is None
    elif use_fast_path:
        diff_supported(features, scene)
    mesh = mesh or pmesh.make_render_mesh([device])
    scene = scene.to(mesh.home)
    params, rebuild, names = split_scene(scene, trainable)
    renderer = InverseRenderer(
        camera=camera.to(mesh.home), width=width, height=height,
        samples=samples, max_depth=max_depth, mesh=mesh, features=features,
        rebuild=rebuild, learning_rate=learning_rate,
        use_fast_path=bool(use_fast_path), silhouette=silhouette,
        silhouette_samples=silhouette_samples, param_names=tuple(names),
    )
    return renderer, renderer.init(params), names
