"""pathtrace_tpu_torch — the PyTorch/CUDA port of :mod:`pathtrace_tpu`.

The first slice renders the fused fast wavefront path for static sphere
scenes: numpy scene building and presets, the counter-hash bounce RNG,
attribute tables, a closest-hit kernel and a fused shade/scatter kernel
(CUDA C++ for Hopper, ``csrc/``), the stream-compaction ladder, primary
rays, film output, the progressive driver and the CLI
(``python -m pathtrace_tpu_torch``). The second adds the inverse-rendering
trainer on one device: the closest hit made differentiable with a
hand-written backward kernel, the differentiable trace, and Adam over the
scene's leaves (``parallel/inverse.py``,
``python -m pathtrace_tpu_torch.examples.inverse_render``). The third
culls the closest hit per sphere tile for scenes of scene scale; the
fourth carries moving spheres (the motion-blurred ``random`` preset)
through the closest hit, the shade kernel and the backward kernel. Frames
and the trainer draw their primary rays from the Threefry twin of
``jax.random`` (``utils/threefry.py``; on the card ``csrc/threefry.cu``),
keyed as the reference's, so a frame reproduces the reference's image.
The general wavefront integrator (``render/integrator.py``: records of
every primitive kind, instanced spheres and rects included, table Perlin
noise and the recursive checker, the material scatter, NEE and roulette;
``render/frame.render_frame``, differentiable through K6) renders every
scene the fast path refuses (instances, checkers with non-constant
children, more than 128 rects): ``--mode general``, or ``auto``'s
fallback. The fast path takes every preset, ``final_full`` through its
non-fused bounce (``fastpath.fast_bounce`` on [R, 3] state, with NEE and
roulette, under the same ladder), as the reference's does. The trainer is whole: the silhouette
boundary term (``ops/silhouette.py``), a differentiable bounce for every
scene class the reference trains, the general path for the rest, and
render and TrainState checkpoints (``utils/checkpoint.py``).

The drivers and surfaces complete it: adaptive sampling
(``render/adaptive.py``), first-hit AOVs and the à-trous denoiser
(``render/aov.py``, ``render/denoise.py``), the live preview
(``render/preview.py``), the ``-X`` ray trace (``utils/debug.py``), the
throughput meter and image comparison (``utils/profiling.py``,
``utils/compare.py``) and the one-call API below.

Every kernel has a plain PyTorch version beside it; a wrapper runs the
plain version only for CPU tensors and launches its CUDA kernel for CUDA
tensors. The package imports torch and numpy, never jax; importing it
builds and loads no CUDA code (the kernels build at their first launch).
"""

__version__ = "0.1.0"

# The exports load on first use (PEP 562), so that importing the package,
# as the CLI does before it parses its arguments, does not import torch.
# The render/ subpackage owns the name `render` at package scope, so the
# one-call API exports as `render_image` (also `pathtrace_tpu_torch.api.render`).
_EXPORTS = {
    "render_image": ("pathtrace_tpu_torch.api", "render"),
    "preset_names": ("pathtrace_tpu_torch.api", "preset_names"),
    "make_camera": ("pathtrace_tpu_torch.camera", "make_camera"),
    "Params": ("pathtrace_tpu_torch.config", "Params"),
    "SceneBuilder": ("pathtrace_tpu_torch.models.build", "SceneBuilder"),
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module, attr = _EXPORTS[name]
    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value
