"""Isosurface extraction on the device: vectorized marching tetrahedra (port
of clid_slam_tpu/ops/marching.py).

Every cube of the grid splits into 6 tetrahedra that share the main
diagonal; each tetrahedron emits 0-2 triangles from a 16-case table. The
output has a fixed capacity (a triangle buffer and its validity mask), and
the caller compacts it. Vertices are placed by linear interpolation along
the edges whose ends change sign, as in the JAX package, in f32 and in its
order of operations: ``t = fa / (fa - fb)`` (the denominator guarded at
1e-12), clipped to [0, 1], ``pa + t * (pb - pa)`` in grid units, then
``origin + tri * resolution``.

Torch ops, not a hand kernel: the JAX package never wrote it in Pallas.
"""

from __future__ import annotations

import numpy as np
import torch

# cube corner offsets, index bit k = axis k
_CORNERS = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int32)

# 6-tetrahedra decomposition sharing diagonal 0-7
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    np.int32,
)

# tetrahedron edges
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)

# case -> up to 2 triangles, each a triple of edge ids (-1 = unused).
# cases 8..14 mirror 7..1 with reversed winding.
_CASE_TRIS = np.full((16, 2, 3), -1, np.int32)
_CASE_TRIS[1, 0] = [0, 1, 2]
_CASE_TRIS[2, 0] = [0, 4, 3]
_CASE_TRIS[3] = [[1, 3, 4], [1, 4, 2]]
_CASE_TRIS[4, 0] = [1, 5, 3]
_CASE_TRIS[5] = [[0, 3, 5], [0, 5, 2]]
_CASE_TRIS[6] = [[0, 4, 5], [0, 5, 1]]
_CASE_TRIS[7, 0] = [2, 4, 5]
for _m in range(8, 15):
    _comp = _CASE_TRIS[15 - _m]
    _CASE_TRIS[_m] = _comp[:, ::-1]  # reverse winding


def marching_tetrahedra(
    sdf_grid: torch.Tensor,  # [X*Y*Z] flattened, x-major: idx = (x*Y + y)*Z + z
    mask_grid: torch.Tensor,  # [X*Y*Z] bool: corner valid for meshing
    origin: torch.Tensor,  # [3] world coords of grid point (0,0,0)
    resolution: float,
    dims: tuple,  # (X, Y, Z)
):
    """Returns (tri_verts [M,3,3] f32 world coords, tri_valid [M] bool) with
    M = (X-1)(Y-1)(Z-1)*6*2, on the device of ``sdf_grid``."""
    X, Y, Z = dims
    cy, cz = Y - 1, Z - 1
    dev = sdf_grid.device
    tab = lambda a: torch.as_tensor(a, device=dev).long()

    cell = torch.arange((X - 1) * cy * cz, device=dev)
    base = torch.stack([cell // (cy * cz), (cell // cz) % cy, cell % cz], -1)  # [C,3]
    corners = base[:, None, :] + tab(_CORNERS)[None]  # [C,8,3]
    flat = (corners[..., 0] * Y + corners[..., 1]) * Z + corners[..., 2]
    f = sdf_grid[flat]  # [C,8]
    cell_ok = torch.all(mask_grid[flat], dim=-1)  # all corners valid

    tets = tab(_TETS)
    tf = f[:, tets]  # [C,6,4]
    tcorn = corners[:, tets, :]  # [C,6,4,3]
    inside = (tf < 0.0).long()  # iso level 0
    case = inside[..., 0] + inside[..., 1] * 2 + inside[..., 2] * 4 + inside[..., 3] * 8

    # the interpolated vertex on each of the 6 tetrahedron edges
    ea, eb = tab(_TET_EDGES[:, 0]), tab(_TET_EDGES[:, 1])
    fa, fb = tf[..., ea], tf[..., eb]  # [C,6,6]
    pa = tcorn[:, :, ea, :].float()  # [C,6,6,3]
    pb = tcorn[:, :, eb, :].float()
    denom = fa - fb
    t = fa / torch.where(denom.abs() > 1e-12, denom, torch.full_like(denom, 1e-12))
    t = torch.clamp(t, 0.0, 1.0)
    everts = pa + t[..., None] * (pb - pa)  # [C,6,6,3] grid coords

    tri_edges = tab(_CASE_TRIS)[case]  # [C,6,2,3]
    tri_ok = (tri_edges[..., 0] >= 0) & cell_ok[:, None, None]
    safe = torch.clamp(tri_edges, min=0)
    # the triangles' vertices: [C,6,2,3 vertices,3 coords]
    C = everts.shape[0]
    tri = torch.gather(everts[:, :, None].expand(C, 6, 2, 6, 3), 3,
                       safe[..., None].expand(C, 6, 2, 3, 3))
    world = origin + tri * resolution
    return world.reshape(-1, 3, 3), tri_ok.reshape(-1)
