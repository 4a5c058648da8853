"""Render configuration (counterpart of ``pathtrace_tpu/config.py``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Params:
    """Render parameters, the reference CLI surface (width, height, samples
    per pixel per frame, bounce depth, seed, ``-B``)."""

    width: int = 1280
    height: int = 720
    samples: int = 4
    max_depth: int = 10
    seed: int = 0
    random_seed: bool = False  # if True, seed from entropy; else ``seed``
    use_bvh: bool = False      # the whole-scene BVH (the reference's -B)

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def resolve_seed(self) -> int:
        if self.random_seed:
            import secrets

            return secrets.randbits(32)
        return self.seed


# Ray-march epsilon bounds (same values as the JAX package).
MIN_T: float = 0.001
MAX_T: float = 3.402823466e38  # f32 max
