"""Procedural geometry.

The reference ships binary OBJ/FBX assets (teapot, bunny, cube, floor —
absent from the mirror, see SURVEY.md §6) loaded through assimp
(include/model.hpp:22-98).  These generators produce equivalent meshes
in-process: analytic normals, uv coordinates, counter-clockwise winding.
"""

from __future__ import annotations

import numpy as np


def _mesh(positions, indices, normals=None, uvs=None):
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    if normals is None:
        normals = np.zeros_like(positions)  # zero = "use geometric normal"
    if uvs is None:
        uvs = np.zeros((len(positions), 2), np.float32)
    return dict(
        positions=positions,
        normals=np.asarray(normals, np.float32),
        uvs=np.asarray(uvs, np.float32),
        indices=indices,
    )


def triangle(p0=(-1, -1, 0), p1=(1, -1, 0), p2=(0, 1, 0)):
    """Single triangle with corner uvs (BASELINE config 1)."""
    return _mesh(
        [p0, p1, p2],
        [[0, 1, 2]],
        normals=None,
        uvs=[[0, 0], [1, 0], [0.5, 1]],
    )


def quad(half: float = 27.5):
    """Square plane in xz at y=0, +y normal — stands in for the reference's
    ``floor.obj`` (scaled 0.1 it spans +-2.75, the Cornell wall size,
    main.cpp:212-237)."""
    h = float(half)
    positions = [[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]]
    normals = [[0, 1, 0]] * 4
    uvs = [[0, 0], [1, 0], [1, 1], [0, 1]]
    indices = [[0, 2, 1], [0, 3, 2]]
    return _mesh(positions, indices, normals, uvs)


def cube(half: float = 1.0):
    """Axis-aligned cube with face normals (stand-in for ``cube.obj``)."""
    h = float(half)
    faces = [
        ((0, 0, 1), [(-h, -h, h), (h, -h, h), (h, h, h), (-h, h, h)]),
        ((0, 0, -1), [(h, -h, -h), (-h, -h, -h), (-h, h, -h), (h, h, -h)]),
        ((1, 0, 0), [(h, -h, h), (h, -h, -h), (h, h, -h), (h, h, h)]),
        ((-1, 0, 0), [(-h, -h, -h), (-h, -h, h), (-h, h, h), (-h, h, -h)]),
        ((0, 1, 0), [(-h, h, h), (h, h, h), (h, h, -h), (-h, h, -h)]),
        ((0, -1, 0), [(-h, -h, -h), (h, -h, -h), (h, -h, h), (-h, -h, h)]),
    ]
    positions, normals, uvs, indices = [], [], [], []
    for n, corners in faces:
        base = len(positions)
        positions.extend(corners)
        normals.extend([n] * 4)
        uvs.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
        indices.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return _mesh(positions, indices, normals, uvs)


def icosphere(subdivisions: int = 3, radius: float = 1.0):
    """Subdivided icosahedron; 20 * 4^n triangles (n=3 -> 1280, n=4 -> 5120)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
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
    normals = v.copy()
    uvs = np.stack(
        [
            np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi) + 0.5,
            0.5 - np.arcsin(np.clip(v[:, 1], -1, 1)) / np.pi,
        ],
        axis=1,
    )
    return _mesh(v * radius, faces, normals, uvs)


def revolution(profile_r, profile_y, segments: int = 48, close_top=False, close_bottom=False):
    """Surface of revolution around +y from a (r, y) profile polyline."""
    profile_r = np.asarray(profile_r, np.float64)
    profile_y = np.asarray(profile_y, np.float64)
    n_prof = len(profile_r)
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    positions, uvs = [], []
    for i in range(n_prof):
        for a in ang:
            positions.append(
                [profile_r[i] * np.cos(a), profile_y[i], profile_r[i] * np.sin(a)]
            )
            uvs.append([a / (2 * np.pi), i / max(n_prof - 1, 1)])
    indices = []
    for i in range(n_prof - 1):
        for j in range(segments):
            j2 = (j + 1) % segments
            a = i * segments + j
            b = i * segments + j2
            c = (i + 1) * segments + j
            d = (i + 1) * segments + j2
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
    indices = np.asarray(indices + caps, np.int32)
    return _mesh(positions, indices, normals=None, uvs=np.asarray(uvs, np.float32))


def tube(path_points, radius: float = 0.12, segments: int = 12):
    """Circular-cross-section tube swept along a 3-D polyline (teapot spout
    and handle)."""
    path = np.asarray(path_points, np.float64)
    n = len(path)
    # parallel-transport-ish frames
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
            positions.append(path[i] + radius * (np.cos(a) * nv + np.sin(a) * bv))
            uvs.append([j / segments, i / max(n - 1, 1)])
    indices = []
    for i in range(n - 1):
        for j in range(segments):
            j2 = (j + 1) % segments
            a = i * segments + j
            b = i * segments + j2
            c = (i + 1) * segments + j
            d = (i + 1) * segments + j2
            indices += [[a, b, d], [a, d, c]]
    return _mesh(np.asarray(positions), np.asarray(indices, np.int32),
                 normals=None, uvs=np.asarray(uvs, np.float32))


def merge(*meshes):
    """Concatenate mesh dicts into one."""
    positions, normals, uvs, indices = [], [], [], []
    offset = 0
    for m in meshes:
        positions.append(m["positions"])
        normals.append(m["normals"])
        uvs.append(m["uvs"])
        indices.append(m["indices"] + offset)
        offset += len(m["positions"])
    return dict(
        positions=np.concatenate(positions),
        normals=np.concatenate(normals),
        uvs=np.concatenate(uvs),
        indices=np.concatenate(indices),
    )


def _resample_profile(r, y, n):
    """Linear resample of a profile polyline to n points."""
    t = np.linspace(0, 1, len(r))
    tt = np.linspace(0, 1, n)
    return np.interp(tt, t, r), np.interp(tt, t, y)


def teapot(segments: int = 72):
    """Procedural stand-in for the Utah ``teapot.obj`` (~6k triangles at the
    default resolution): body + lid as surfaces of revolution, spout and
    handle as swept tubes.  Sits on y=0, overall height ~3.2, like a teapot.
    """
    # body profile (r, y)
    body_r, body_y = _resample_profile(
        [0.01, 0.9, 1.3, 1.5, 1.45, 1.25, 0.95, 0.9],
        [0.0, 0.08, 0.5, 1.1, 1.6, 2.0, 2.25, 2.3],
        16,
    )
    body = revolution(body_r, body_y, segments=segments, close_bottom=True)
    # lid profile
    lid_r, lid_y = _resample_profile(
        [0.9, 0.6, 0.35, 0.2, 0.22, 0.12, 0.01],
        [2.3, 2.42, 2.55, 2.7, 2.85, 3.0, 3.15],
        12,
    )
    lid = revolution(lid_r, lid_y, segments=segments, close_top=True)
    # spout: swept tube from body out and up
    t = np.linspace(0, 1, 24)
    spout_path = np.stack(
        [1.2 + 1.5 * t, 0.9 + 1.5 * t * t + 0.6 * t, np.zeros_like(t)], axis=1
    )
    spout = tube(spout_path, radius=0.22, segments=max(8, segments // 4))
    # handle: half-ellipse on the other side
    a = np.linspace(-0.45 * np.pi, 0.45 * np.pi, 28)
    handle_path = np.stack(
        [-1.15 - 0.85 * np.cos(a), 1.45 + 0.95 * np.sin(a), np.zeros_like(a)], axis=1
    )
    handle = tube(handle_path, radius=0.14, segments=max(8, segments // 4))
    return merge(body, lid, spout, handle)
