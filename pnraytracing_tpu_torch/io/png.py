"""From-scratch PNG reader (RFC 2083) — numpy + zlib, no image library.

The reference loads LDR textures through stb_image (model.hpp:57-76 via
assimp); this is the TPU build's first-party counterpart, covering the PNG
subset Blender/stb actually emit: 8/16-bit, grayscale / RGB / palette /
alpha variants, non-interlaced, filters 0-4.  The writer half lives in
utils/image.py (stored-deflate) and csrc/image_io.cpp.

PyTorch port: a copy of ``pnraytracing_tpu/io/png.py`` (host numpy code,
the same names and return structures).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"

# color type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a.astype(np.int16) + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo per-scanline filtering.  raw is [h, 1 + stride] u8 (filter byte
    + data).  Returns [h, stride] u8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f = int(raw[y, 0])
        line = raw[y, 1:].copy()
        if f == 0:
            pass
        elif f == 1:  # Sub: cumulative per channel-phase (mod 256)
            for p in range(bpp):
                line[p::bpp] = np.cumsum(line[p::bpp], dtype=np.uint32) & 0xFF
        elif f == 2:  # Up
            line = (line.astype(np.uint16) + prev) & 0xFF
            line = line.astype(np.uint8)
        elif f == 3:  # Average — left-dependent, per-pixel loop
            line16 = line.astype(np.uint16)
            for x in range(stride):
                left = int(line16[x - bpp]) if x >= bpp else 0
                line16[x] = (line16[x] + ((left + int(prev[x])) >> 1)) & 0xFF
            line = line16.astype(np.uint8)
        elif f == 4:  # Paeth — left-dependent, per-pixel loop
            line16 = line.astype(np.int16)
            for x in range(stride):
                a = int(line16[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                line16[x] = (line16[x] + int(_paeth(
                    np.uint8(a), np.uint8(b), np.uint8(c)))) & 0xFF
            line = line16.astype(np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter {f} on row {y}")
        out[y] = line
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to [h, w, c] float32 in [0, 1] (c = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _MAGIC:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = bytearray()
    palette = None
    trns = None
    w = h = depth = ctype = None
    interlace = 0
    while pos + 8 <= len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length  # length + tag + data + crc
        if tag == b"IHDR":
            w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
        elif tag == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
    if w is None:
        raise ValueError(f"{path}: missing IHDR")
    if interlace:
        raise ValueError(f"{path}: Adam7 interlacing not supported")
    if depth not in (8, 16) and not (ctype == 3 and depth in (1, 2, 4, 8)):
        raise ValueError(f"{path}: unsupported bit depth {depth}")

    nchan = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
    if ctype == 3 and depth < 8:  # sub-byte palette indices
        bits_per_px = depth
        stride = (w * bits_per_px + 7) // 8
        rows = raw.reshape(h, 1 + stride)
        un = _unfilter(rows, h, stride, 1)
        # unpack bits, MSB first
        bits = np.unpackbits(un, axis=1)[:, : w * depth]
        idx = bits.reshape(h, w, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (idx * weights).sum(-1).astype(np.uint8)
        img = palette[px].astype(np.float32) / 255.0
        return img
    bytes_per_sample = depth // 8
    bpp = nchan * bytes_per_sample
    stride = w * bpp
    rows = raw.reshape(h, 1 + stride)
    un = _unfilter(rows, h, stride, bpp)
    if depth == 16:
        arr = un.reshape(h, w, nchan, 2)
        vals = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
        img = vals.astype(np.float32) / 65535.0
    else:
        img = un.reshape(h, w, nchan).astype(np.float32) / 255.0
    if ctype == 3:
        pal = palette.astype(np.float32) / 255.0
        img = pal[(img[..., 0] * 255).astype(np.uint8)]
        if trns is not None:
            a = np.ones(img.shape[:2], np.float32)
            lut = np.ones(256, np.float32)
            lut[: len(trns)] = trns.astype(np.float32) / 255.0
            a = lut[(un.reshape(h, w)).astype(np.uint8)]
            img = np.concatenate([img, a[..., None]], -1)
    return img


def read_png_rgb(path: str) -> np.ndarray:
    """[h, w, 3] float32; drops alpha, broadcasts grayscale."""
    img = read_png(path)
    c = img.shape[-1]
    if c == 1:
        return np.repeat(img, 3, axis=-1)
    if c == 2:  # gray + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    if c == 4:
        return img[..., :3]
    return img
