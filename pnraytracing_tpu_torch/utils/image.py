"""Image output.

PyTorch counterpart of ``pnraytracing_tpu/utils/image.py``.  The
reference displays through a GL blit (shaders/render.*) and never saves
to disk despite vendoring stb_image_write (PnRT.hpp:7-9); the port's
display path is a file.  :func:`save_png` writes the PNG itself (zlib +
struct, RFC 2083: 8-bit RGB, filter 0 on every row), so it needs no
image library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _host(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    return np.asarray(image, np.float32)


def tonemap(image, gamma: float = 2.2, exposure: float = 1.0) -> np.ndarray:
    """Linear radiance -> display [0,1] with simple gamma.  The reference's
    blit shows the clamped linear buffer directly (render.frag); gamma is
    optional here for nicer previews.  Takes a numpy array or a tensor on
    any device; returns numpy."""
    img = np.clip(_host(image) * exposure, 0.0, 1.0)
    if gamma and gamma != 1.0:
        img = img ** (1.0 / gamma)
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, image, gamma: float = 2.2) -> None:
    """Save an [H, W, 3] linear float image as an 8-bit RGB PNG, with the
    JAX package's quantization ``uint8(tonemap * 255 + 0.5)``."""
    img8 = (tonemap(image, gamma=gamma) * 255.0 + 0.5).astype(np.uint8)
    h, w, c = img8.shape
    if c != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {img8.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img8.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                            0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def mse(a, b) -> float:
    return float(np.mean((np.asarray(_host(a), np.float64)
                          - np.asarray(_host(b), np.float64)) ** 2))
