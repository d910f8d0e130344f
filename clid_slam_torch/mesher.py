"""Mesh reconstruction from the neural SDF map (port of
clid_slam_tpu/mesher.py).

Capabilities of the reference Mesher (utils/mesher.py:38-667): batched SDF
queries over dense grids with a min-neighbour validity mask, chunked
reconstruction over AABBs, marching-tetrahedra surface extraction, SDF
slice clouds, vertex colors and classes, and isolated-cluster filtering.

- Grid chunks have one shape, chunk_dim³ points; chunks at the volume's
  border are masked, not shrunk.
- A chunk's points go through ``query_feature`` (the hand gather kernels
  on the card: ``gather_rows`` for the hash-mirror probe and the feature
  rows, ``gather_lanes`` for the kNN selection), the decoder and
  ``ops/marching.py`` on the device; only the valid triangles come back to
  the host (the compaction).
- Vertex welding and the isolated-cluster filter are host numpy passes,
  copies of the JAX package's (``_weld_mesh``), so both packages weld the
  same soup into the same mesh.

Each method runs on the device of the map it is given. The launch spans
``mesh.query``, ``mesh.decode``, ``mesh.marching`` and ``mesh.compaction``
place the device time in a profile.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .models import decoder as dec
from .models import neural_map as nm
from .ops.marching import marching_tetrahedra
from .utils import observability as obs


class Mesher:
    def __init__(
        self,
        *,
        knn_k: int,
        nb_offs,
        resolution: float,
        max_valid_dist2: float,
        sdf_scale: float,
        mesh_min_nn: int = 8,
        chunk_dim: int = 48,
        mlp_leaky: bool = False,
        mlp_bf16: bool = False,
        feature_dim: int = 8,
        rotate_vecs: bool = False,
        encode_vecs=None,
        weighted_first: bool = True,
        layer_norm: bool = False,
    ):
        self.chunk_dim = int(chunk_dim)
        self.mesh_min_nn = mesh_min_nn
        self.knn_k = knn_k
        self.offs = torch.as_tensor(nb_offs)
        self.resolution = resolution
        self.max_valid_dist2 = max_valid_dist2
        self.sdf_scale = sdf_scale
        self.feature_dim = feature_dim
        self.dec_kw = dict(leaky=mlp_leaky, bf16=mlp_bf16)
        self.query_kw = dict(rotate_vecs=rotate_vecs, encode_vecs=encode_vecs,
                             weighted_first=weighted_first, layer_norm=layer_norm)
        self.weighted_first = weighted_first

    def _query(self, map_state, pts):
        with obs.span("mesh.query"):
            return nm.query_feature(
                map_state, pts, self.offs.to(pts.device), self.resolution,
                self.max_valid_dist2, self.knn_k, **self.query_kw,
            )

    def _weighted(self, x, q):
        """Decode-then-weight (utils/mesher.py:130-147): the decoded
        neighbours summed with their IDW weights."""
        if self.weighted_first:
            return x
        w = q.weights if x.dim() == 2 else q.weights[..., None]
        return torch.sum(x * w, dim=1)

    @torch.no_grad()
    def query_chunk(self, map_state, mlp, pts, valid_in):
        """(sdf [N], ok [N]): ok where ``valid_in`` and the point has at
        least ``mesh_min_nn`` neighbours."""
        q = self._query(map_state, pts)
        with obs.span("mesh.decode"):
            sdf = self._weighted(dec.sdf(mlp, q.feature, self.sdf_scale, **self.dec_kw), q)
        return sdf, valid_in & (q.nn_count >= self.mesh_min_nn)

    @torch.no_grad()
    def color_chunk(self, map_state, color_mlp, pts, valid_in):
        """Vertex color regression (utils/mesher.py:425-443 semantics): the
        same kNN query, the color-feature slab, the sigmoid color head."""
        q = self._query(map_state, pts)
        with obs.span("mesh.decode"):
            cfeat = nm.query_color_feature(map_state, q, self.feature_dim)
            color = self._weighted(dec.regress_color(color_mlp, cfeat, **self.dec_kw), q)
        return color, valid_in & (q.nn_count >= self.mesh_min_nn)

    @torch.no_grad()
    def sem_chunk(self, map_state, sem_mlp, pts, valid_in):
        """Vertex semantic argmax (utils/mesher.py:401-423 semantics)."""
        q = self._query(map_state, pts)
        with obs.span("mesh.decode"):
            logp = self._weighted(dec.sem_label_prob(sem_mlp, q.feature, **self.dec_kw), q)
            labels = torch.argmax(logp, dim=-1).to(torch.int32)
        return labels, valid_in & (q.nn_count >= self.mesh_min_nn)

    def chunk_points(self, origin: torch.Tensor, mc_res: float) -> torch.Tensor:
        """The chunk's grid points [cd³, 3], x-major, in f32."""
        r = torch.arange(self.chunk_dim, dtype=torch.float32, device=origin.device)
        grid = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
        return origin[None, :] + grid * mc_res

    @torch.no_grad()
    def mesh_chunk(self, map_state, mlp, origin, mc_res, valid_in):
        """One chunk's triangles: ([M, 3, 3] world coords, [M] valid),
        M = (cd-1)³ * 12."""
        cd = self.chunk_dim
        sdf, ok = self.query_chunk(map_state, mlp, self.chunk_points(origin, mc_res), valid_in)
        with obs.span("mesh.marching"):
            return marching_tetrahedra(sdf, ok, origin, mc_res, (cd, cd, cd))

    # ------------------------------------------------------------- meshing
    def triangle_soup(
        self,
        map_state,
        mlp,
        aabb_min: np.ndarray,
        aabb_max: np.ndarray,
        mc_res: float,
        pad_voxel: int = 2,
        guide_points: Optional[np.ndarray] = None,
        skip_top_voxel: int = 0,
    ) -> Tuple[np.ndarray, int]:
        """The valid triangles [T, 3, 3] of every chunk over the AABB, on
        the host, and the number of chunks meshed (``recon_aabb_mesh``
        welds them)."""
        cd = self.chunk_dim
        aabb_min = np.asarray(aabb_min, np.float64) - pad_voxel * mc_res
        aabb_max = np.asarray(aabb_max, np.float64) + pad_voxel * mc_res
        aabb_max[2] -= skip_top_voxel * mc_res
        span = np.maximum(aabb_max - aabb_min, mc_res)
        # chunks overlap by one grid point so cells at borders are covered
        step = (cd - 1) * mc_res
        nx, ny, nz = [max(1, int(np.ceil(s / step))) for s in span]

        if guide_points is not None and len(guide_points):
            occupied = set()
            pad = pad_voxel * mc_res
            for d in np.array(
                [[-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
                 [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1]],
                np.float64,
            ):
                # dilate by the pad margin so near-boundary surface cells
                # are still covered
                g = np.floor((guide_points + d * pad - aabb_min) / step).astype(np.int64)
                np.clip(g, 0, [nx - 1, ny - 1, nz - 1], out=g)
                occupied.update(map(tuple, np.unique(g, axis=0)))
            chunk_ids = sorted(occupied)
        else:
            chunk_ids = [(ix, iy, iz) for ix in range(nx) for iy in range(ny) for iz in range(nz)]

        dev = map_state.positions.device
        all_tris = []
        valid_in = torch.ones((cd**3,), dtype=torch.bool, device=dev)
        for cid in chunk_ids:
            origin = aabb_min + np.asarray(cid, np.float64) * step
            origin_d = torch.as_tensor(origin.astype(np.float32), device=dev)
            tris, ok = self.mesh_chunk(map_state, mlp, origin_d, mc_res, valid_in)
            with obs.span("mesh.compaction"):
                tri_np = tris[ok].cpu().numpy()
            if skip_top_voxel > 0:
                tri_np = tri_np[(tri_np[..., 2] <= aabb_max[2]).all(axis=-1)]
            if len(tri_np):
                all_tris.append(tri_np)
        if not all_tris:
            return np.zeros((0, 3, 3), np.float32), len(chunk_ids)
        return np.concatenate(all_tris, 0), len(chunk_ids)

    def recon_aabb_mesh(
        self,
        map_state,
        mlp,
        aabb_min: np.ndarray,
        aabb_max: np.ndarray,
        mc_res: float,
        pad_voxel: int = 2,
        min_cluster_vertices: int = 0,
        guide_points: Optional[np.ndarray] = None,
        skip_top_voxel: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Chunked reconstruction over an AABB (utils/mesher.py:523-667
        semantics). Returns (vertices [V,3], triangles [T,3]) as numpy
        arrays.

        ``guide_points`` (usually the live neural-point positions) restricts
        the sweep to occupied chunks, like the reference's point-guided
        chunk split (utils/tools.py:727-799). ``skip_top_voxel`` trims the
        top of the z range (utils/mesher.py:178-181)."""
        soup, _ = self.triangle_soup(map_state, mlp, aabb_min, aabb_max, mc_res, pad_voxel,
                                     guide_points, skip_top_voxel)
        if not len(soup):
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
        return _weld_mesh(soup, mc_res, min_cluster_vertices)

    # ------------------------------------------------- vertex attributes
    def _query_attr(self, chunk_fn, map_state, mlp, pts, fill):
        """Run a per-chunk attribute query over arbitrary points in
        fixed-size padded batches."""
        cd3 = self.chunk_dim**3
        n = len(pts)
        if n == 0:
            return np.zeros((0,) + np.shape(fill), np.asarray(fill).dtype), np.zeros(0, bool)
        dev = map_state.positions.device
        n_pad = ((n + cd3 - 1) // cd3) * cd3
        buf = np.zeros((n_pad, 3), np.float32)
        buf[:n] = pts
        outs, oks = [], []
        for i in range(0, n_pad, cd3):
            valid = torch.arange(i, i + cd3, device=dev) < n
            o, ok = chunk_fn(map_state, mlp, torch.as_tensor(buf[i : i + cd3], device=dev), valid)
            outs.append(o.cpu().numpy())
            oks.append(ok.cpu().numpy())
        return np.concatenate(outs)[:n], np.concatenate(oks)[:n]

    def estimate_vertex_colors(
        self, map_state, color_mlp, verts: np.ndarray, color_channel: int = 3
    ) -> np.ndarray:
        """Per-vertex color in [0,1] (utils/mesher.py:425-443). Intensity
        maps (color_channel=1) are doubled and replicated to gray like the
        reference."""
        color, ok = self._query_attr(self.color_chunk, map_state, color_mlp, verts, np.zeros(3))
        if color_channel == 1:
            color = np.repeat(np.clip(color[:, :1] * 2.0, 0, 1), 3, axis=1)
        else:
            color = np.clip(color[:, :3], 0, 1)
        color[~ok] = 0.5
        return color

    def estimate_vertex_sem(
        self, map_state, sem_mlp, verts: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-vertex semantic labels and keep-mask; label 0 = free space is
        filtered like the reference (utils/mesher.py:418-421)."""
        labels, ok = self._query_attr(self.sem_chunk, map_state, sem_mlp, verts, np.int32(0))
        return labels, ok & (labels > 0)

    # ------------------------------------------------------------ SDF grid
    def query_sdf_points(self, map_state, mlp, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Query arbitrary points in fixed-size padded batches; returns
        (sdf [N], valid [N])."""
        return self._query_attr(self.query_chunk, map_state, mlp, pts, np.float32(0))

    def sdf_slice(self, map_state, mlp, center: np.ndarray, extent: float, height: float,
                  res: float):
        """Horizontal SDF slice visualization points
        (utils/mesher.py:281-334, 460-521). Returns (points [N,3],
        sdf [N], valid [N])."""
        xs = np.arange(center[0] - extent, center[0] + extent, res)
        ys = np.arange(center[1] - extent, center[1] + extent, res)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        pts = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, height)], -1).astype(np.float32)
        sdf, ok = self.query_sdf_points(map_state, mlp, pts)
        return pts, sdf, ok

    def sdf_slice_vertical(self, map_state, mlp, center: np.ndarray, extent: float,
                           slice_x: float, res: float, z_lo: float = None, z_hi: float = None):
        """Vertical SDF slice at world x = slice_x (the reference's
        get_query_from_ver_slice, utils/mesher.py:246-279: a y-z grid with
        the x dimension collapsed to the slice plane). Returns
        (points [N,3], sdf [N], valid [N])."""
        ys = np.arange(center[1] - extent, center[1] + extent, res)
        if z_lo is None:
            z_lo = center[2] - extent
        if z_hi is None:
            z_hi = center[2] + extent
        zs = np.arange(z_lo, z_hi, res)
        gy, gz = np.meshgrid(ys, zs, indexing="ij")
        pts = np.stack([np.full(gy.size, slice_x), gy.ravel(), gz.ravel()], -1).astype(np.float32)
        sdf, ok = self.query_sdf_points(map_state, mlp, pts)
        return pts, sdf, ok


def filter_mesh_vertices(
    verts: np.ndarray, tris: np.ndarray, keep: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop masked-out vertices and every triangle touching one
    (o3d remove_vertices_by_mask equivalent, utils/mesher.py:419-421).
    Returns (verts, tris, old->kept vertex index of survivors)."""
    keep = np.asarray(keep, bool)
    remap = np.full(len(verts), -1, np.int64)
    kept_idx = np.flatnonzero(keep)
    remap[kept_idx] = np.arange(len(kept_idx))
    tri_keep = keep[tris].all(-1)
    return verts[keep], remap[tris[tri_keep]], kept_idx


# SemanticKITTI label palette (BGR in the dataset spec; stored here as RGB
# in [0,1]) for the 20-class remapped training ids — the public color
# convention used by the reference's sem_kitti_color_map.
SEM_KITTI_COLORS = (
    np.array(
        [
            (0, 0, 0),  # 0 unlabeled / free space
            (100, 150, 245),  # 1 car
            (100, 230, 245),  # 2 bicycle
            (30, 60, 150),  # 3 motorcycle
            (80, 30, 180),  # 4 truck
            (0, 0, 255),  # 5 other-vehicle
            (255, 30, 30),  # 6 person
            (255, 40, 200),  # 7 bicyclist
            (150, 30, 90),  # 8 motorcyclist
            (255, 0, 255),  # 9 road
            (255, 150, 255),  # 10 parking
            (75, 0, 75),  # 11 sidewalk
            (175, 0, 75),  # 12 other-ground
            (255, 200, 0),  # 13 building
            (255, 120, 50),  # 14 fence
            (0, 175, 0),  # 15 vegetation
            (135, 60, 0),  # 16 trunk
            (150, 240, 80),  # 17 terrain
            (255, 240, 150),  # 18 pole
            (255, 0, 0),  # 19 traffic-sign
        ],
        np.float64,
    )
    / 255.0
)


def _weld_mesh(
    tri_soup: np.ndarray, mc_res: float, min_cluster_vertices: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge duplicate vertices (quantized to a fraction of the cell size)
    and optionally drop small connected components
    (utils/mesher.py:445-458 semantics). The key is computed on the f32
    soup exactly as the JAX package computes it: another float width welds
    other vertices."""
    flat = tri_soup.reshape(-1, 3)
    key = np.round(flat / (mc_res * 1e-3)).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    # representative position: first occurrence of each welded vertex
    first = np.full(len(uniq), len(flat), np.int64)
    np.minimum.at(first, inv, np.arange(len(flat)))
    verts = flat[first]
    tris = inv.reshape(-1, 3)
    # drop degenerate triangles
    good = (tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])
    tris = tris[good]

    if min_cluster_vertices > 1 and len(verts):
        tris = tris[_cluster_keep(tris, len(verts), min_cluster_vertices)]
    return verts.astype(np.float32), tris


def _cluster_keep(tris: np.ndarray, n_verts: int, min_cluster_vertices: int) -> np.ndarray:
    """The triangles whose connected component (union-find over the
    triangles' vertices, the JAX package's links and path halving in its
    order, on Python ints) holds at least ``min_cluster_vertices``
    vertices."""
    parent = list(range(n_verts))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b, c in tris.tolist():
        ra, rb, rc = find(a), find(b), find(c)
        parent[rb] = ra
        parent[rc] = ra
    roots = np.array([find(i) for i in range(n_verts)], np.int64)
    counts = np.bincount(roots, minlength=n_verts)
    keep_v = counts[roots] >= min_cluster_vertices
    return keep_v[tris].all(-1)
