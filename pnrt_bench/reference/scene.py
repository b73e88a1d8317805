"""The reference's scene: everything the plain path tracer reads, worked
out from a configuration's recipe (``pnrt_bench/scenes``) and nothing
that the program made.

- Geometry: the models flattened into world space in input order (the
  transform and normal-matrix arithmetic of the upstream loader, in
  float64 then rounded to float32), each triangle's corners, corner
  normals and material id.
- Lights: the emissive triangles in the order the program's light list
  holds them (``light_order.py``), their prefix areas (float64 areas of
  the float32 corners, summed in that order, rounded to float32).
- Environment: the luminance pdf, and Walker alias tables of the marginal
  and of each column (Vose's construction on the host, in float64).
- Acceleration: triangles grouped into clusters of 64 along a Morton
  curve of their centroids, with each cluster's box (``accel.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pnrt_bench.reference.light_order import light_triangle_order

MATERIAL_DEFAULTS = dict(
    emissive=(0.0, 0.0, 0.0), base_color=(0.8, 0.8, 0.8), subsurface=0.0,
    metallic=0.0, specular=0.0, specular_tint=0.0, roughness=0.5,
    anisotropic=0.0, sheen=0.0, sheen_tint=0.0, clearcoat=0.0,
    clearcoat_gloss=0.0, ior=1.0, transmission=0.0)
MATERIAL_FIELDS = tuple(MATERIAL_DEFAULTS)


def alias_table(p: np.ndarray):
    """Walker alias table of a probability vector (Vose): sample
    j = floor(u n), keep j when the fraction is below ``prob[j]``, else
    take ``alias[j]``."""
    n = len(p)
    p = np.asarray(p, np.float64)
    s = p.sum()
    p = p / s if s > 0 else np.full(n, 1.0 / n)
    prob = np.zeros(n)
    alias = np.arange(n, dtype=np.int64)
    scaled = p * n
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = scaled[s_i]
        alias[s_i] = l_i
        scaled[l_i] = (scaled[l_i] + scaled[s_i]) - 1.0
        (small if scaled[l_i] < 1.0 else large).append(l_i)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias


@dataclasses.dataclass
class EnvTables:
    """``pdf_xy`` [W, H] (pdf[x][y] of the luminance 0.2/0.7/0.1),
    ``prob_x``/``alias_x`` [W], ``prob_y``/``alias_y`` [W, H]."""

    pdf_xy: torch.Tensor
    prob_x: torch.Tensor
    alias_x: torch.Tensor
    prob_y: torch.Tensor
    alias_y: torch.Tensor


def env_tables(image: np.ndarray, device, dtype) -> EnvTables:
    img = np.asarray(image, np.float32)
    lum = 0.2 * img[..., 0] + 0.7 * img[..., 1] + 0.1 * img[..., 2]
    pdf_xy = lum.T.copy()
    pdf_xy /= max(pdf_xy.sum(), 1e-20)
    w, h = pdf_xy.shape
    prob_x, al_x = alias_table(pdf_xy.sum(axis=1))
    prob_y = np.zeros((w, h), np.float32)
    al_y = np.zeros((w, h), np.int64)
    for x in range(w):
        prob_y[x], al_y[x] = alias_table(pdf_xy[x])
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=device).to(dtype)
    i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    return EnvTables(pdf_xy=f(pdf_xy), prob_x=f(prob_x), alias_x=i(al_x),
                     prob_y=f(prob_y), alias_y=i(al_y))


@dataclasses.dataclass
class RefScene:
    """Triangles in input order: ``p`` [T, 3, 3] corners, ``n`` [T, 3, 3]
    corner normals, ``mat`` [T]; ``materials`` a dict of [M] / [M, 3]
    tensors; ``light_tri`` [L], ``prefix_area`` [L], ``total_area`` 0-d;
    ``env_image`` [H, W, 3] and its ``env`` tables; ``accel`` the
    cluster boxes; ``dtype`` the precision every float is held in."""

    p: torch.Tensor
    n: torch.Tensor
    mat: torch.Tensor
    materials: dict
    light_tri: torch.Tensor
    prefix_area: torch.Tensor
    total_area: torch.Tensor
    env_image: torch.Tensor
    env: EnvTables
    accel: object
    dtype: torch.dtype

    @property
    def device(self):
        return self.p.device


def flatten(models):
    """(positions [V, 3] f32, normals [V, 3] f32, indices [T, 3] i64,
    material ids [T], material dicts) of the models in input order."""
    pos_l, nrm_l, idx_l, mat_l, mats = [], [], [], [], []
    off = 0
    for mesh, material, _name, xf in models:
        pos = np.asarray(mesh["positions"], np.float64)
        nrm = np.asarray(mesh["normals"], np.float64)
        idx = np.asarray(mesh["indices"], np.int64)
        if xf is not None:
            pos = pos @ xf[:3, :3].T + xf[:3, 3]
            n_mat = np.linalg.inv(xf[:3, :3]).T
            nz = np.any(nrm != 0, axis=1)
            nrm = nrm @ n_mat.T
            nrm = np.where(nz[:, None], nrm / np.maximum(
                np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20), 0.0)
        pos_l.append(pos.astype(np.float32))
        nrm_l.append(nrm.astype(np.float32))
        idx_l.append(idx + off)
        mat_l.append(np.full(len(idx), len(mats), np.int64))
        mats.append(material)
        off += len(pos)
    return (np.concatenate(pos_l), np.concatenate(nrm_l),
            np.concatenate(idx_l), np.concatenate(mat_l), mats)


def material_table(mats: list[dict], device, dtype) -> dict:
    return {k: torch.tensor([m.get(k, dv) for m in mats], dtype=torch.float32,
                            device=device).to(dtype)
            for k, dv in MATERIAL_DEFAULTS.items()}


def build(recipe, device, dtype=torch.float32) -> RefScene:
    from pnrt_bench.reference.accel import Clusters

    positions, normals, indices, mat_ids, mats = flatten(recipe.models)
    emissive = np.stack([np.asarray(m.get("emissive", (0.0, 0.0, 0.0)),
                                    np.float32) for m in mats])
    is_light = np.any(emissive[mat_ids] != 0.0, axis=1)
    light_tri = light_triangle_order(positions, indices, is_light,
                                     recipe.max_leaf_size)
    corners = positions[indices].astype(np.float64)
    areas = 0.5 * np.linalg.norm(np.cross(corners[:, 1] - corners[:, 0],
                                          corners[:, 2] - corners[:, 0]),
                                 axis=1)
    prefix = np.cumsum(areas[light_tri]).astype(np.float32)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=device).to(dtype)
    p = f(positions[indices])
    return RefScene(
        p=p, n=f(normals[indices]),
        mat=torch.as_tensor(mat_ids, device=device),
        materials=material_table(mats, device, dtype),
        light_tri=torch.as_tensor(light_tri, device=device),
        prefix_area=f(prefix), total_area=f(prefix[-1]),
        env_image=f(recipe.env), env=env_tables(recipe.env, device, dtype),
        accel=Clusters(p), dtype=dtype)
