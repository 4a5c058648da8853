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
scene the fast path refuses, ``final_full`` among them: ``--mode
general``, or ``auto``'s fallback. The trainer is whole: the silhouette
boundary term (``ops/silhouette.py``), a differentiable bounce for every
scene class the reference trains, the general path for the rest, and
render and TrainState checkpoints (``utils/checkpoint.py``).

Every kernel has a plain PyTorch version beside it; a wrapper runs the
plain version only for CPU tensors and launches its CUDA kernel for CUDA
tensors. The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
