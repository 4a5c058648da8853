"""Utilities of the port: the Threefry twin of ``jax.random``."""
