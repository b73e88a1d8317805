"""Scene data model: plain dataclasses of tensors.

PyTorch counterpart of ``pnraytracing_tpu/core/types.py``.  Where the JAX
package uses ``flax.struct.dataclass`` pytrees, the port uses plain
dataclasses whose fields are tensors on one device; ``.to(device)`` moves
a whole structure.  Field names and shapes are the JAX package's, so
``convert.py`` can carry a JAX-built scene over leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pnraytracing_tpu_torch.core.math import clip, maximum


def _map(obj, fn):
    """Copy of a dataclass with ``fn`` applied to every tensor
    (recursively)."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _map(v, fn)
    return dataclasses.replace(obj, **changes)


def tensors(obj):
    """Every tensor of a dataclass, recursively, in field order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))


class _Movable:
    def to(self, device):
        """A copy with every tensor on ``device``."""
        return _map(self, lambda t: t.to(device))

    def detach(self):
        """A copy with every tensor detached from the autograd graph
        (``jax.lax.stop_gradient`` of a pytree)."""
        return _map(self, torch.Tensor.detach)


_MATERIAL_DEFAULTS = dict(
    emissive=(0.0, 0.0, 0.0),
    base_color=(0.8, 0.8, 0.8),
    subsurface=0.0,
    metallic=0.0,
    specular=0.0,
    specular_tint=0.0,
    roughness=0.5,
    anisotropic=0.0,
    sheen=0.0,
    sheen_tint=0.0,
    clearcoat=0.0,
    clearcoat_gloss=0.0,
    ior=1.0,
    transmission=0.0,
)
_SCALAR_PARAMS = tuple(k for k in _MATERIAL_DEFAULTS
                       if k not in ("emissive", "base_color"))


@dataclasses.dataclass
class Materials(_Movable):
    """Disney principled BRDF parameters, one row per material
    (PnRT.hpp:66-81): [M, 3] colors and [M] scalars."""

    emissive: torch.Tensor
    base_color: torch.Tensor
    subsurface: torch.Tensor
    metallic: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    roughness: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor

    @classmethod
    def stack(cls, mats: list[dict], device=None) -> "Materials":
        """From per-material dicts; missing keys get the reference
        defaults (PnRT.hpp:66-81)."""
        return cls(**{
            key: torch.tensor([m.get(key, dval) for m in mats],
                              dtype=torch.float32, device=device)
            for key, dval in _MATERIAL_DEFAULTS.items()
        })

    def sanitized(self) -> "Materials":
        """Every parameter clamped to its physical domain (the ranges of
        the reference's sliders, ImGuiLayer.hpp:60-71), as ``jnp.clip`` /
        ``jnp.maximum`` clamp it: the same values as ``torch.clamp``,
        and a parameter exactly on a bound (the default 0.0 of most
        fields, a roughness of 1) gets half its gradient, as in JAX
        (core/math.py)."""
        unit = lambda a: clip(a, 0.0, 1.0)
        return Materials(
            emissive=maximum(self.emissive, 0.0),
            base_color=unit(self.base_color),
            subsurface=unit(self.subsurface),
            metallic=unit(self.metallic),
            specular=unit(self.specular),
            specular_tint=unit(self.specular_tint),
            roughness=unit(self.roughness),
            anisotropic=unit(self.anisotropic),
            sheen=unit(self.sheen),
            sheen_tint=unit(self.sheen_tint),
            clearcoat=unit(self.clearcoat),
            clearcoat_gloss=unit(self.clearcoat_gloss),
            ior=maximum(self.ior, 1.0),
            transmission=unit(self.transmission),
        )

    def gather_components(self, idx: torch.Tensor):
        """Per-ray material fetch: ``(scalars, base V3, emissive V3)``.

        ``scalars`` holds the 12 scalar parameters as [R] tensors; its
        color slots are zero placeholders (the V3s carry the colors).  A
        gather picks the same values as the JAX package's compare-select
        chain.  All 14 fields go through one ``ops/gather.py::gather_rows``
        node: the values of ``index_select``, and a backward that sums each
        material's lanes in a fixed order, once for all the fields
        (``index_select``'s own backward adds with atomics, in any order;
        ``table[idx]``'s sums each material's run of lanes serially, 98%
        of a 512x512 backward on the card, PERF.md)."""
        from pnraytracing_tpu_torch.core.vec import V3
        from pnraytracing_tpu_torch.ops.gather import gather_rows

        zero = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
        *fields, base, emissive = gather_rows(
            idx, *(getattr(self, k) for k in _SCALAR_PARAMS),
            self.base_color, self.emissive)
        scalars = Materials(emissive=zero, base_color=zero,
                            **dict(zip(_SCALAR_PARAMS, fields)))
        return scalars, V3.of(base), V3.of(emissive)


@dataclasses.dataclass
class TriangleMesh(_Movable):
    """World-space flattened geometry (model.hpp:101-135); triangle arrays
    are in BVH leaf order."""

    positions: torch.Tensor  # [V, 3] f32
    normals: torch.Tensor  # [V, 3] f32 (zero rows = no vertex normal)
    tangents: torch.Tensor  # [V, 3] f32
    bitangents: torch.Tensor  # [V, 3] f32
    uvs: torch.Tensor  # [V, 2] f32
    indices: torch.Tensor  # [T, 3] i32
    material_id: torch.Tensor  # [T] i32
    texture_id: torch.Tensor  # [T] i32 (-1 = untextured)
    area: torch.Tensor  # [T] f32


@dataclasses.dataclass
class BVH(_Movable):
    """Flat SAH BVH, depth-first (BVH.hpp:6-12): left child at id + 1,
    ``right_child == -1`` marks a leaf over triangles [start, end)."""

    node_min: torch.Tensor  # [N, 3] f32
    node_max: torch.Tensor  # [N, 3] f32
    axis: torch.Tensor  # [N] i32
    right_child: torch.Tensor  # [N] i32
    start: torch.Tensor  # [N] i32
    end: torch.Tensor  # [N] i32


@dataclasses.dataclass
class Lights(_Movable):
    """Emissive-triangle light list with inclusive prefix areas."""

    tri_index: torch.Tensor  # [L] i32
    prefix_area: torch.Tensor  # [L] f32
    total_area: torch.Tensor  # [] f32

    @property
    def count(self) -> int:
        return self.tri_index.shape[0]


@dataclasses.dataclass
class EnvMap(_Movable):
    """Equirectangular HDR environment and its sampling tables
    (ops/envmap.py::build_envmap)."""

    image: torch.Tensor  # [H, W, 3] f32
    pdf_xy: torch.Tensor  # [W, H] f32
    cdf_marginal_x: torch.Tensor  # [W] f32
    cdf_y_given_x: torch.Tensor  # [W, H] f32
    alias_x: Optional[torch.Tensor] = None  # [W, 2] f32
    alias_y: Optional[torch.Tensor] = None  # [W, H, 2] f32
    alias_fat: Optional[torch.Tensor] = None  # [W*H, 10] f32
    quad12: Optional[torch.Tensor] = None  # [H, W, 12] f32

    @property
    def height(self) -> int:
        return self.image.shape[0]

    @property
    def width(self) -> int:
        return self.image.shape[1]


@dataclasses.dataclass
class TextureAtlas(_Movable):
    """Stacked 2-D base-color textures (main.cpp:527-554), padded to a
    common size: ``data`` [K, H, W, 3] f32 in [0, 1], ``sizes`` [K, 2]
    i32 (width, height) of each, and the optional box-filtered mip strip
    ``mips`` [K, H, W, 3] (level l of texture k at rows
    [h - (h >> (l-1)), h - (h >> l)), width w >> l;
    ops/texture.py::build_atlas)."""

    data: torch.Tensor
    sizes: torch.Tensor
    mips: Optional[torch.Tensor] = None

    @property
    def count(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class Camera(_Movable):
    """Pinhole ray-gen basis (camera.hpp:11-31)."""

    eye: torch.Tensor  # [3]
    lower_left: torch.Tensor  # [3]
    horizontal: torch.Tensor  # [3]
    vertical: torch.Tensor  # [3]

    def copy_(self, other: "Camera") -> "Camera":
        """Copy ``other``'s basis into these tensors in place (a captured
        frame's camera buffers, render/program.py)."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))
        return self


@dataclasses.dataclass
class Scene(_Movable):
    """Everything the integrator reads.  ``textures`` is the base-color
    atlas (None: no textured model); ``trav`` is the traversal layout
    (accel/layout.py::TravData); ``env_constant`` is the constant-radiance
    environment used when there is no HDR map; ``bvh_depth`` is the BVH's
    max node depth, checked against ``RenderConfig.stack_depth`` before
    every traversal."""

    mesh: TriangleMesh
    materials: Materials
    bvh: BVH
    lights: Lights
    env: Optional[EnvMap] = None
    textures: Optional[TextureAtlas] = None
    trav: Optional["object"] = None
    env_constant: Optional[torch.Tensor] = None  # [3]
    bvh_depth: Optional[int] = None
