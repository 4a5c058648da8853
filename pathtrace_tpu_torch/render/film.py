"""Film output and image input: sRGB conversion, a dependency-free PNG
writer and reader, and the PNG/JPEG sniffing loader of image textures
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


def read_image(path: str) -> np.ndarray:
    """Read a PNG or a JPEG to [H, W, 3] uint8, told apart by their magic
    bytes (the reference's format-agnostic ``image::open``)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\xff\xd8":
        from pathtrace_tpu_torch.render.jpeg import read_jpeg

        return read_jpeg(path)
    if magic == b"\x89P":
        return read_png(path)
    raise ValueError(f"{path}: not a PNG or JPEG (magic {magic!r})")


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader: 8-bit RGB, filters 0-4 (none, sub, up, average,
    Paeth), one row at a time."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", body[:10])
            if bit_depth != 8 or color_type != 2:
                raise ValueError(f"{path}: only 8-bit RGB PNGs are read")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for row in range(h):
        ftype = raw[row * (stride + 1)]
        line = np.frombuffer(
            raw[row * (stride + 1) + 1:(row + 1) * (stride + 1)], np.uint8
        ).astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - 3] if i >= 3 else 0
                b = prev[i]
                c = prev[i - 3] if i >= 3 else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:  # Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        out[row] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, 3)


def save_frame_png(path: str, img_linear: np.ndarray) -> None:
    """sRGB + vertical flip (row 0 is the bottom while rendering) + PNG."""
    write_png(path, to_srgb_u8(np.asarray(img_linear)[::-1]))
