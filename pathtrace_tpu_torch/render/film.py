"""Film output: sRGB conversion and a dependency-free PNG writer
(counterpart of ``pathtrace_tpu/render/film.py``; numpy on the host)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_srgb_u8(img_linear: np.ndarray) -> np.ndarray:
    """[H, W, 3] linear float -> [H, W, 3] u8 (1.055 x^(1/2.4) - 0.055,
    clamped, quantized with * 255.99)."""
    img = np.maximum(np.asarray(img_linear, dtype=np.float32), 0.0)
    srgb = np.clip(1.055 * img ** np.float32(0.41666666) - 0.055, 0.0, 1.0)
    return (srgb * 255.99).astype(np.uint8)


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """Encode [H, W, 3] u8 RGB as PNG bytes (8-bit, no filtering)."""
    img = np.asarray(rgb_u8, dtype=np.uint8)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb_u8))


def save_frame_png(path: str, img_linear: np.ndarray) -> None:
    """sRGB + vertical flip (row 0 is the bottom while rendering) + PNG."""
    write_png(path, to_srgb_u8(np.asarray(img_linear)[::-1]))
