"""pathtrace_tpu_torch — the PyTorch/CUDA port of :mod:`pathtrace_tpu`.

The first slice renders the fused fast wavefront path for static sphere
scenes: numpy scene building and presets, the counter-hash bounce RNG,
attribute tables, a closest-hit kernel and a fused shade/scatter kernel
(CUDA C++ for Hopper, ``csrc/``), the stream-compaction ladder, primary
rays, film output, the progressive driver and the CLI
(``python -m pathtrace_tpu_torch``).

Every kernel has a plain PyTorch version beside it; a wrapper runs the
plain version only for CPU tensors and launches its CUDA kernel for CUDA
tensors. The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
