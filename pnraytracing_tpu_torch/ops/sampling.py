"""Random and low-discrepancy sampling.

PyTorch counterpart of ``pnraytracing_tpu/ops/sampling.py``
(ray_tracing.comp:496-624): the wang-hash counter RNG with explicit seed
threading (no generator object), the Sobol sequence with
Cranley-Patterson rotation, area-light selection, uniform triangle
sampling and the cosine- and uniform-hemisphere samples in their
[R, 3] forms.

32-bit words live in int64 tensors holding values in [0, 2^32): torch
has no working shift on uint32 on every backend, and every product below
stays under 2^63 before the mask.  Floats are made from the unsigned
value, exactly as the JAX package converts its uint32.

The frame counter is a Python int or a 0-d integer tensor, either taken
modulo 2^32 (the JAX package's ``jnp.asarray(frame, jnp.uint32)``).  The
tensor form keeps every use of the frame on the device, so a captured
frame (``render/program.py``) reads the counter of each replay: the
Sobol pair of :func:`sobol_vec2` is then computed on the device, bit for
bit the value the int form computes on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pnraytracing_tpu_torch.core.math import TWO_PI, safe_sqrt

M32 = 0xFFFFFFFF
_INV_2_32 = 1.0 / 4294967296.0
_INV_U32 = float(np.float32(1.0 / 0xFFFFFFFF))  # the Sobol scale, an f32


def wang_hash(seed: torch.Tensor) -> torch.Tensor:
    """One PRNG step (comp:499-506); returns the new seed (also the
    32-bit draw)."""
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & M32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & M32
    return seed ^ (seed >> 15)


def u32_to_unit(word: torch.Tensor) -> torch.Tensor:
    """A 32-bit word to float32 in [0, 1]: f32(word) * 2^-32."""
    return word.to(torch.float32) * _INV_2_32


def rand01(seed: torch.Tensor):
    """(new_seed, uniform in [0,1)) — ``Rand0To1`` (comp:528-530)."""
    seed = wang_hash(seed)
    return seed, u32_to_unit(seed)


def frame_word(frame):
    """The frame counter modulo 2^32: an int stays an int, an integer
    tensor becomes a 0-d int64 tensor on its device."""
    if isinstance(frame, torch.Tensor):
        return frame.reshape(()).to(torch.int64) & M32
    return int(frame) & M32


def pixel_seed(x: torch.Tensor, y: torch.Tensor, frame) -> torch.Tensor:
    """Per-pixel stream seed (comp:977-979):
    (x*1973 + y*9277 + frame*26699) | 1, mod 2^32; ``frame`` an int or a
    0-d tensor (:func:`frame_word`)."""
    s = x * 1973 + y * 9277 + frame_word(frame) * 26699
    return (s & M32) | 1


# Joe-Kuo (new-joe-kuo-6) parameters for Sobol dimensions 1..7.
_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
]

SOBOL_DIMS = 8
SOBOL_BITS = 32


@functools.lru_cache(maxsize=1)
def sobol_direction_table() -> np.ndarray:
    """[SOBOL_DIMS, 32] uint32 direction numbers (the reference's literal
    V[8*32] table, comp:508-510)."""
    table = np.zeros((SOBOL_DIMS, SOBOL_BITS), np.uint32)
    for k in range(1, SOBOL_BITS + 1):
        table[0, k - 1] = np.uint32(1) << np.uint32(32 - k)
    for dim, (s, a, m) in enumerate(_JOE_KUO, start=1):
        v = np.zeros(SOBOL_BITS + 1, np.uint64)
        for k in range(1, s + 1):
            v[k] = np.uint64(m[k - 1]) << np.uint64(32 - k)
        for k in range(s + 1, SOBOL_BITS + 1):
            acc = v[k - s] ^ (v[k - s] >> np.uint64(s))
            for i in range(1, s):
                if (a >> (s - 1 - i)) & 1:
                    acc ^= v[k - i]
            v[k] = acc
        table[dim] = v[1:].astype(np.uint32)
    return table


def gray_code(i):
    """i ^ (i >> 1) of a 32-bit word (a Python int or an int64 tensor of
    words, taken modulo 2^32)."""
    i = i & M32
    return i ^ (i >> 1)


def sobol_u32(d: int, i: int) -> int:
    """32-bit Sobol value of index i in dimension d (comp:518-526)."""
    v = sobol_direction_table()[d]
    out = 0
    for bit in range(32):
        if (i >> bit) & 1:
            out ^= int(v[bit])
    return out


def sobol_float(d: int, i: int) -> float:
    """f32(u32) * f32(1/0xFFFFFFFF), as a Python float holding that f32."""
    return float(np.float32(sobol_u32(d, i)) * np.float32(_INV_U32))


@functools.lru_cache(maxsize=8)
def _sobol_device_table(device: torch.device):
    """(the direction numbers [SOBOL_DIMS, 32] as int64, the bit shifts
    0..31 [32]) on ``device``, made once: the first frame on a device
    makes them, so a captured frame copies nothing from the host."""
    table = torch.as_tensor(sobol_direction_table().astype(np.int64),
                            device=device)
    return table, torch.arange(SOBOL_BITS, dtype=torch.int64, device=device)


def sobol_vec2(frame, bounce: int):
    """The (u, v) pair of bounce b for frame i (comp:533-537): dimensions
    (2b, 2b+1) mod 8 at the gray-coded index.  One pair per frame, shared
    by every pixel (the per-pixel shift comes from the rotation).  An int
    ``frame`` gives two Python floats (each holding an f32); a 0-d tensor
    gives two 0-d float32 tensors of the same values, computed on its
    device: the XOR of the direction numbers at the index's set bits,
    each output bit the parity of its column."""
    d0 = (2 * bounce) % SOBOL_DIMS  # even, so d0 + 1 is the second one
    i = frame_word(frame)
    g = i ^ (i >> 1)
    if not isinstance(g, torch.Tensor):
        return sobol_float(d0, g), sobol_float(d0 + 1, g)
    table, shifts = _sobol_device_table(g.device)
    terms = table[d0:d0 + 2] * ((g >> shifts) & 1)  # [2, 32]
    parity = ((terms[:, :, None] >> shifts) & 1).sum(dim=1) & 1
    word = (parity << shifts).sum(dim=1)  # [2]
    uv = word.to(torch.float32) * _INV_U32
    return uv[0], uv[1]


def cranley_patterson_rotation_c(su, sv, px: torch.Tensor, py: torch.Tensor,
                                 width: int, height: int, salt: int = 0):
    """Per-pixel toroidal shift of the sample (su, sv) (comp:539-557),
    with the reference's ``x*W*1973 + y*H*9277 + 59*26699`` seed mix.
    ``su``, ``sv``: Python floats or 0-d float32 tensors (the two forms
    of :func:`sobol_vec2`), added in float32 either way.
    ``salt`` (the integrator passes 2*bounce // SOBOL_DIMS) gives each
    reuse of the 8-dim table past depth 4 a fresh shift; 0 keeps the
    reference's bits."""
    s = (px * ((width * 1973) & M32) + py * ((height * 9277) & M32)
         + (114514 // 1919) * 26699 + ((int(salt) * 0x9E3779B9) & M32))
    s = (s & M32) | 1
    s, u = rand01(s)
    _, v = rand01(s)
    a = su + u
    b = sv + v
    return torch.where(a > 1.0, a - 1.0, a), torch.where(b > 1.0, b - 1.0, b)


def cranley_patterson_rotation(p: torch.Tensor, px: torch.Tensor,
                               py: torch.Tensor, width: int,
                               height: int) -> torch.Tensor:
    """Per-pixel toroidal shift of samples ``p`` [..., 2] (comp:539-557):
    the array form of :func:`cranley_patterson_rotation_c` without a
    salt."""
    a, b = cranley_patterson_rotation_c(p[..., 0], p[..., 1], px, py, width,
                                        height)
    return torch.stack([a, b], dim=-1)


def pick_light(prefix_area: torch.Tensor, total_area: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Area-proportional light slot (GetLightIndex, comp:237-251): the
    smallest slot with prefix >= u * total."""
    slot = torch.searchsorted(prefix_area, u * total_area, side="left")
    return torch.clamp(slot, 0, prefix_area.shape[0] - 1).to(torch.int32)


def sample_uniform_triangle(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform barycentrics (comp:598-601): b0 = 1 - sqrt(u1),
    b1 = u2 * sqrt(u1)."""
    su = safe_sqrt(u1)
    return 1.0 - su, u2 * su


def sample_cosine_hemisphere_local(u1: torch.Tensor, u2: torch.Tensor,
                                   compat: bool = False) -> torch.Tensor:
    """[R, 3] local-frame direction of the diffuse lobe: the true
    cosine-weighted hemisphere (pdf cos / pi, comp:734/780), or with
    ``compat`` the reference's SampleCosineHemisphere (comp:642-647),
    which reads u1 as an angle in radians and u2 as the radius.  The
    integrator samples through ``ops/brdf.py::
    sample_cosine_hemisphere_local_v``, its component form."""
    if compat:
        x = u2 * torch.sin(u1)
        y = u2 * torch.cos(u1)
    else:
        r = safe_sqrt(u1)
        phi = TWO_PI * u2
        x = r * torch.cos(phi)
        y = r * torch.sin(phi)
    return torch.stack([x, y, safe_sqrt(1.0 - x * x - y * y)], dim=-1)


def sample_uniform_hemisphere_local(u1: torch.Tensor,
                                    u2: torch.Tensor) -> torch.Tensor:
    """[..., 3] uniform hemisphere direction in the local frame
    (UniformSampleHemisphere, comp:590-595): z = u1, r = sqrt(1 - z^2)."""
    r = safe_sqrt(1.0 - u1 * u1)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), u1], dim=-1)
