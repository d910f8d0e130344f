"""Offline map inspector (port of clid_slam_tpu/tools/inspect_map.py):
reload a saved checkpoint, re-mesh, export.

Equivalent of the reference's vis_pin_map.py:49-212 (load pin_map.pth,
rebuild hash, optional mesh extraction at a chosen resolution), headless:
artifacts are PLY files, and the input is the ``.npz`` checkpoint that
either package's ``SlamSystem.save_checkpoint`` writes.

Usage:
    python -m clid_slam_torch.tools.inspect_map CKPT.npz [-m MC_RES] [-o OUT_DIR]
        [--mesh-min-nn N] [--sdf-slice-height Z] [--device cpu]

It runs on the card unless ``--device cpu`` is given. As the JAX package's
inspector, it builds its ``Mesher`` from the geometry the checkpoint
carries and nothing else: no positional encoding and no layer norm
(ROADMAP C8).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint", help="map_checkpoint.npz from a run")
    ap.add_argument("-m", "--mc-res", type=float, default=0.0,
                    help="marching resolution (m); 0 = skip meshing")
    ap.add_argument("-o", "--out", default=".", help="output directory")
    ap.add_argument("--mesh-min-nn", type=int, default=8)
    ap.add_argument("--sdf-slice-height", type=float, default=None,
                    help="also export a horizontal SDF slice at this z (m)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..mesher import Mesher
    from ..models import decoder as dec
    from ..models import neural_map as nm
    from ..ops.voxel import neighbor_offsets
    from ..utils import io

    dev = resolve_device(args.device)
    z = np.load(args.checkpoint)
    t = lambda a, dtype: torch.as_tensor(np.asarray(a, dtype), device=dev)
    state = nm.NeuralMapState(
        positions=t(z["positions"], np.float32),
        quats=t(z["quats"], np.float32),
        geo_feats=t(z["geo_feats"], np.float32),
        color_feats=t(z["color_feats"], np.float32)
        if "color_feats" in z
        else torch.zeros((z["geo_feats"].shape[0], 1), device=dev),
        certainty=t(z["certainty"], np.float32),
        ts_create=t(z["ts_create"], np.int32),
        ts_update=t(z["ts_update"], np.int32),
        count=t(z["count"], np.int32),
        hash_table=t(z["hash_table"], np.int32),
        hash_mirror=t(z["hash_mirror"], np.float32)
        if "hash_mirror" in z
        else torch.full((z["hash_table"].shape[0], 4), 1e9, device=dev),
    )
    mlp = dec.MLPParams(
        [t(z["mlp_weights"], np.float32)], [t(z["mlp_biases"], np.float32)],
        t(z["mlp_w_out"], np.float32), t(z["mlp_b_out"], np.float32),
    )
    n = int(state.count)
    feature_dim = state.geo_feats.shape[1]
    print(f"# neural points: {n}  (feature dim {feature_dim})")
    print(f"# map memory: {nm.memory_mb(state, feature_dim):.2f} MB")

    os.makedirs(args.out, exist_ok=True)
    pts = state.positions[:n].cpu().numpy()
    cert = state.certainty[:n].cpu().numpy()
    # certainty-colored point export (gui color_mode=3 analog,
    # model/neural_points.py:291-314)
    cmax = max(float(cert.max()), 1e-9)
    gray = np.clip(1.0 - cert / cmax, 0, 1)
    io.write_ply(os.path.join(args.out, "neural_points.ply"), pts,
                 colors=np.stack([gray, gray, gray], -1))
    print(f"wrote {args.out}/neural_points.ply")

    if args.mc_res > 0 and n > 0:
        # query geometry from the checkpoint (newer checkpoints carry it);
        # fall back to env override, then nearest-neighbor inference
        res = (
            float(z["voxel_size_m"])
            if "voxel_size_m" in z
            else float(os.environ.get("CLID_VOXEL_SIZE_M", 0.0)) or _infer_res(pts)
        )
        cells = int(z["num_nei_cells"]) if "num_nei_cells" in z else 2
        alpha = float(z["search_alpha"]) if "search_alpha" in z else 0.5
        knn_k = int(z["query_nn_k"]) if "query_nn_k" in z else 6
        sdf_scale = float(z["sdf_scale"]) if "sdf_scale" in z else 0.055
        mesher = Mesher(
            knn_k=knn_k,
            nb_offs=neighbor_offsets(cells, alpha),
            resolution=res,
            max_valid_dist2=3.0 * ((cells + 1) * res) ** 2,
            sdf_scale=sdf_scale,
            mesh_min_nn=args.mesh_min_nn,
        )
        v, tris = mesher.recon_aabb_mesh(state, mlp, pts.min(0), pts.max(0), args.mc_res)
        io.write_ply_mesh(os.path.join(args.out, "mesh.ply"), v, tris)
        print(f"wrote {args.out}/mesh.ply ({len(v)} verts, {len(tris)} tris)")

        if args.sdf_slice_height is not None:
            center = pts.mean(0)
            p, s, ok = mesher.sdf_slice(
                state, mlp, center, float(np.abs(pts - center).max()),
                args.sdf_slice_height, args.mc_res,
            )
            # seismic-style colormap: blue(+) -> white -> red(-)
            sn = np.clip(s / 0.5, -1, 1)
            col = np.stack([np.clip(1 - sn, 0, 1), 1 - np.abs(sn), np.clip(1 + sn, 0, 1)], -1)
            io.write_ply(os.path.join(args.out, "sdf_slice.ply"), p[ok], colors=col[ok])
            print(f"wrote {args.out}/sdf_slice.ply")


def _infer_res(pts: np.ndarray) -> float:
    """Median nearest-neighbor spacing of a subsample ~ voxel size."""
    sub = pts[:: max(1, len(pts) // 2000)]
    d = np.linalg.norm(sub[None, :, :] - sub[:, None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return float(np.median(d.min(1)))


if __name__ == "__main__":
    main()
