"""Statistical image-parity comparison (counterpart of
``pathtrace_tpu/utils/compare.py``; numpy).

Two renderers with different random streams cannot agree bit for bit,
so parity is statistical: two unbiased renders of the same scene must
agree in per-pixel mean within Monte Carlo noise. This module holds that
comparison for golden-regression tests and for parity against an
external PNG (``pathtrace_tpu_torch/tools/compare_golden.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ParityReport:
    mean_abs_error: float
    rmse: float
    p99_abs_error: float
    mean_signed_error: float  # bias estimate: ~0 for unbiased pairs
    psnr_db: float

    def summary(self) -> str:
        return (
            f"MAE={self.mean_abs_error:.5f} RMSE={self.rmse:.5f} "
            f"p99={self.p99_abs_error:.5f} bias={self.mean_signed_error:+.5f} "
            f"PSNR={self.psnr_db:.2f}dB"
        )


def compare_images(a: np.ndarray, b: np.ndarray) -> ParityReport:
    """Compare two linear-RGB images of identical shape."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, f"{a.shape} vs {b.shape}"
    diff = a - b
    mae = float(np.abs(diff).mean())
    rmse = float(np.sqrt((diff ** 2).mean()))
    p99 = float(np.quantile(np.abs(diff), 0.99))
    bias = float(diff.mean())
    peak = max(float(a.max()), float(b.max()), 1e-9)
    psnr = float(10.0 * np.log10(peak * peak / max(rmse * rmse, 1e-18)))
    return ParityReport(mae, rmse, p99, bias, psnr)


def downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Box-downsample an [H, W, 3] image (averages Monte Carlo noise away:
    the scale for statistical parity checks)."""
    h, w, c = img.shape
    h2, w2 = h // factor, w // factor
    return (
        img[: h2 * factor, : w2 * factor]
        .reshape(h2, factor, w2, factor, c)
        .mean(axis=(1, 3))
    )


def assert_statistical_parity(a: np.ndarray, b: np.ndarray, mae_tol: float,
                              bias_tol: float,
                              downsample_factor: int = 4) -> ParityReport:
    """Raise AssertionError unless a and b agree within tolerance after a
    noise-averaging downsample."""
    rep = compare_images(downsample(a, downsample_factor),
                         downsample(b, downsample_factor))
    assert rep.mean_abs_error < mae_tol, f"MAE too high: {rep.summary()}"
    assert abs(rep.mean_signed_error) < bias_tol, \
        f"bias too high: {rep.summary()}"
    return rep
