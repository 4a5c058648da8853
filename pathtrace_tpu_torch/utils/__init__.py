"""Utilities of the port: the Threefry twin of ``jax.random``, checkpoints,
the native builder, throughput counters, image comparison and the
single-ray debug trace."""
