"""Procedural meshes and transforms the benchmark's scenes are made of.

Frozen copies of the generators that the port's scene catalog uses
(``scene/shapes.py``: ``quad``, ``icosphere``, ``teapot`` with its
surfaces of revolution and swept tubes; ``scene/transform.py``), so the
benchmark makes the triangle soup itself and hands the same arrays to
the program (through ``SceneBuilder.add``) and to the reference.  A mesh
is a dict of numpy arrays: ``positions`` [V, 3] f32, ``normals`` [V, 3]
f32 (zero rows: use the geometric normal), ``uvs`` [V, 2] f32,
``indices`` [T, 3] i32.
"""

from __future__ import annotations

import numpy as np


def _mesh(positions, indices, normals=None, uvs=None):
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    if normals is None:
        normals = np.zeros_like(positions)
    if uvs is None:
        uvs = np.zeros((len(positions), 2), np.float32)
    return dict(positions=positions, normals=np.asarray(normals, np.float32),
                uvs=np.asarray(uvs, np.float32), indices=indices)


def quad(half: float = 27.5):
    """Square in xz at y = 0 with +y normals."""
    h = float(half)
    positions = [[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]]
    normals = [[0, 1, 0]] * 4
    uvs = [[0, 0], [1, 0], [1, 1], [0, 1]]
    return _mesh(positions, [[0, 2, 1], [0, 3, 2]], normals, uvs)


def icosphere(subdivisions: int = 3, radius: float = 1.0):
    """Subdivided icosahedron: 20 * 4^n triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(v) for v in verts]
    cache: dict[tuple[int, int], int] = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = np.asarray(verts[a]) + np.asarray(verts[b])
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(tuple(m))
        return cache[key]

    for _ in range(subdivisions):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    v = np.asarray(verts, np.float64)
    uvs = np.stack([np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi) + 0.5,
                    0.5 - np.arcsin(np.clip(v[:, 1], -1, 1)) / np.pi], axis=1)
    return _mesh(v * radius, faces, v.copy(), uvs)


def _revolution(profile_r, profile_y, segments, close_top=False,
                close_bottom=False):
    profile_r = np.asarray(profile_r, np.float64)
    profile_y = np.asarray(profile_y, np.float64)
    n_prof = len(profile_r)
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    positions, uvs = [], []
    for i in range(n_prof):
        for a in ang:
            positions.append([profile_r[i] * np.cos(a), profile_y[i],
                              profile_r[i] * np.sin(a)])
            uvs.append([a / (2 * np.pi), i / max(n_prof - 1, 1)])
    indices = []
    for i in range(n_prof - 1):
        for j in range(segments):
            j2 = (j + 1) % segments
            a, b = i * segments + j, i * segments + j2
            c, d = (i + 1) * segments + j, (i + 1) * segments + j2
            indices += [[a, d, b], [a, c, d]]
    positions = np.asarray(positions, np.float64)
    caps = []
    if close_bottom and profile_r[0] > 1e-9:
        center = len(positions)
        positions = np.vstack([positions, [[0, profile_y[0], 0]]])
        uvs.append([0.5, 0.0])
        for j in range(segments):
            caps.append([center, j, (j + 1) % segments])
    if close_top and profile_r[-1] > 1e-9:
        center = len(positions)
        positions = np.vstack([positions, [[0, profile_y[-1], 0]]])
        uvs.append([0.5, 1.0])
        base = (n_prof - 1) * segments
        for j in range(segments):
            caps.append([center, base + (j + 1) % segments, base + j])
    return _mesh(positions, np.asarray(indices + caps, np.int32),
                 uvs=np.asarray(uvs, np.float32))


def _tube(path_points, radius, segments):
    path = np.asarray(path_points, np.float64)
    n = len(path)
    tangents = np.gradient(path, axis=0)
    tangents /= np.linalg.norm(tangents, axis=1, keepdims=True) + 1e-12
    up = np.array([0.0, 1.0, 0.0])
    positions, uvs = [], []
    prev_n = None
    for i in range(n):
        t = tangents[i]
        ref = up if abs(np.dot(t, up)) < 0.95 else np.array([1.0, 0.0, 0.0])
        nv = np.cross(t, ref)
        nv /= np.linalg.norm(nv) + 1e-12
        if prev_n is not None and np.dot(nv, prev_n) < 0:
            nv = -nv
        prev_n = nv
        bv = np.cross(t, nv)
        for j in range(segments):
            a = 2 * np.pi * j / segments
            positions.append(path[i] + radius * (np.cos(a) * nv
                                                 + np.sin(a) * bv))
            uvs.append([j / segments, i / max(n - 1, 1)])
    indices = []
    for i in range(n - 1):
        for j in range(segments):
            j2 = (j + 1) % segments
            a, b = i * segments + j, i * segments + j2
            c, d = (i + 1) * segments + j, (i + 1) * segments + j2
            indices += [[a, b, d], [a, d, c]]
    return _mesh(np.asarray(positions), np.asarray(indices, np.int32),
                 uvs=np.asarray(uvs, np.float32))


def _merge(*meshes):
    out = {k: [] for k in ("positions", "normals", "uvs", "indices")}
    offset = 0
    for m in meshes:
        for k in ("positions", "normals", "uvs"):
            out[k].append(m[k])
        out["indices"].append(m["indices"] + offset)
        offset += len(m["positions"])
    return {k: np.concatenate(v) for k, v in out.items()}


def _resample(r, y, n):
    t = np.linspace(0, 1, len(r))
    tt = np.linspace(0, 1, n)
    return np.interp(tt, t, r), np.interp(tt, t, y)


def teapot(segments: int = 72):
    """The procedural teapot (5,692 triangles at 72 segments): body and lid
    as surfaces of revolution, spout and handle as swept tubes."""
    body = _revolution(*_resample(
        [0.01, 0.9, 1.3, 1.5, 1.45, 1.25, 0.95, 0.9],
        [0.0, 0.08, 0.5, 1.1, 1.6, 2.0, 2.25, 2.3], 16),
        segments, close_bottom=True)
    lid = _revolution(*_resample(
        [0.9, 0.6, 0.35, 0.2, 0.22, 0.12, 0.01],
        [2.3, 2.42, 2.55, 2.7, 2.85, 3.0, 3.15], 12),
        segments, close_top=True)
    t = np.linspace(0, 1, 24)
    spout = _tube(np.stack([1.2 + 1.5 * t, 0.9 + 1.5 * t * t + 0.6 * t,
                            np.zeros_like(t)], axis=1),
                  0.22, max(8, segments // 4))
    a = np.linspace(-0.45 * np.pi, 0.45 * np.pi, 28)
    handle = _tube(np.stack([-1.15 - 0.85 * np.cos(a), 1.45 + 0.95 * np.sin(a),
                             np.zeros_like(a)], axis=1),
                   0.14, max(8, segments // 4))
    return _merge(body, lid, spout, handle)


SHAPES = {"quad": quad, "icosphere": icosphere, "teapot": teapot}


def translate(x, y, z) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def scale(x, y=None, z=None) -> np.ndarray:
    if y is None:
        y = z = x
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


def rotate(angle_deg: float, axis) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[:3, :3] = np.array(
        [[c + x * x * (1 - c), x * y * (1 - c) - z * s,
          x * z * (1 - c) + y * s],
         [y * x * (1 - c) + z * s, c + y * y * (1 - c),
          y * z * (1 - c) - x * s],
         [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
          c + z * z * (1 - c)]])
    return m


TRANSFORMS = {"translate": translate, "scale": scale, "rotate": rotate}


def compose(steps) -> np.ndarray:
    """``[[op, args], ...]`` -> the product of the ops in list order (the
    last is applied first), as ``compose(A, B, C) = A @ B @ C``."""
    out = np.eye(4)
    for op, args in steps:
        out = out @ TRANSFORMS[op](*args)
    return out
