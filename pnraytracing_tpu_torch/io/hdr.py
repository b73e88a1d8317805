"""Radiance RGBE (.hdr) image IO.

The reference loads HDR environments through ``stbi_loadf``
(include/shader.hpp:131).  This is a from-scratch numpy reader for the
Radiance picture format: ASCII header, ``-Y H +X W`` resolution line, then
per-scanline data either flat RGBE or adaptive-RLE (the common case for
stb/photoshop-written files).  Also provides a procedural sky generator used
as a stand-in when no .hdr asset is available (the mirror lost most of the
reference's HDR files, SURVEY.md §6).
"""

from __future__ import annotations

import numpy as np


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 RGBE -> [..., 3] float32 radiance."""
    rgbe = rgbe.astype(np.int32)
    exp = rgbe[..., 3]
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 128 - 8))
    return (rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32))


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> [H, W, 3] float32 (top row first)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    # header: lines until blank, then resolution line
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported resolution line: {res}")
    height, width = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.zeros((height, width, 4), np.uint8)
    i = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and i + 4 <= len(buf)
            and buf[i] == 2
            and buf[i + 1] == 2
            and ((int(buf[i + 2]) << 8) | int(buf[i + 3])) == width
        ):
            # adaptive RLE scanline: 4 component planes
            i += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[i])
                    i += 1
                    if count > 128:  # run
                        out[y, x : x + count - 128, c] = buf[i]
                        i += 1
                        x += count - 128
                    else:  # literal
                        out[y, x : x + count, c] = buf[i : i + count]
                        i += count
                        x += count
        else:
            # flat scanline (possibly old-style RLE, rare; handle runs)
            x = 0
            while x < width:
                px = buf[i : i + 4]
                if px[0] == 255 and px[1] == 255 and px[2] == 255:
                    # old run-length: repeat previous pixel
                    rep = int(px[3])
                    out[y, x : x + rep] = out[y, x - 1]
                    x += rep
                else:
                    out[y, x] = px
                    x += 1
                i += 4
    return _decode_rgbe(out)


def write_hdr(path: str, image: np.ndarray) -> None:
    """Write [H, W, 3] float32 radiance as flat (non-RLE) RGBE."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    m = image.max(axis=-1)
    nz = m > 1e-32
    _, e = np.frexp(np.where(nz, m, 1.0))  # m = f * 2^e, f in [0.5, 1)
    sc = np.where(nz, np.ldexp(np.float64(256.0), -e), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    for c in range(3):
        rgbe[..., c] = np.clip(image[..., c] * sc, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    with open(path, "wb") as fo:
        fo.write(header)
        fo.write(rgbe.tobytes())


def procedural_sky(height: int = 256, width: int = 512, sun_dir=(0.4, 0.6, 0.3),
                   sun_intensity: float = 50.0, sky_tint=(0.35, 0.5, 0.85),
                   horizon=(0.9, 0.75, 0.6), ground=(0.18, 0.14, 0.12)) -> np.ndarray:
    """Analytic HDR sky: gradient + sun disc — a stand-in environment with
    enough dynamic range to exercise importance sampling."""
    sun = np.asarray(sun_dir, np.float64)
    sun /= np.linalg.norm(sun)
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    phi = 2 * np.pi * (uu - 0.5)
    theta = np.pi * (0.5 - vv)  # elevation
    d = np.stack(
        [np.cos(theta) * np.cos(phi), np.sin(theta), np.cos(theta) * np.sin(phi)],
        axis=-1,
    )
    up = np.clip(d[..., 1], -1, 1)
    sky = np.asarray(sky_tint) * (0.35 + 0.65 * np.clip(up, 0, 1))[..., None]
    hor = np.asarray(horizon) * np.exp(-np.abs(up) * 4.0)[..., None]
    gnd = np.asarray(ground) * np.clip(-up, 0, 1)[..., None]
    cos_sun = np.clip(np.einsum("...i,i->...", d, sun), -1, 1)
    disc = sun_intensity * np.exp((cos_sun - 1.0) * 2500.0)
    glow = 0.4 * np.exp((cos_sun - 1.0) * 12.0)
    img = sky + hor + gnd + (disc + glow)[..., None] * np.array([1.0, 0.9, 0.75])
    return img.astype(np.float32)
