"""Off-host live viewer for a running SLAM system (the port's copy of
clid_slam_tpu/tools/live_viewer.py).

Connects to a `LiveViewPublisher` (pipeline/liveview.py) and renders the
streamed packets with Open3D — the 5%-of-the-LoC capability analog of the
reference's in-process GUI (gui/slam_gui.py): live neural points (PCA
feature colors are computed publisher-side), current scan, latest mesh,
SDF slice, and the trajectory polyline.

Run on any machine with open3d installed (not the training host):

  python -m clid_slam_torch.tools.live_viewer --host <slam-host> --port 9876

Keys: open3d's default navigation. The window updates in place as
packets arrive; topics toggle via the flags below.
"""

from __future__ import annotations

import argparse
import socket


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9876)
    ap.add_argument("--no-scan", action="store_true")
    ap.add_argument("--no-map", action="store_true")
    ap.add_argument("--no-mesh", action="store_true")
    args = ap.parse_args(argv)

    try:
        import open3d as o3d
    except ImportError:
        raise SystemExit(
            "open3d is required for the live viewer (pip install open3d); "
            "run it on a workstation, not the training host"
        )
    import numpy as np

    from ..pipeline.liveview import read_packet

    sock = socket.create_connection((args.host, args.port))
    vis = o3d.visualization.Visualizer()
    vis.create_window("clid-slam-torch live view")

    geoms = {}

    def upsert(name, geom, reset_bbox=False):
        if name in geoms:
            vis.update_geometry(geoms[name])
        else:
            geoms[name] = geom
            vis.add_geometry(geom, reset_bounding_box=reset_bbox)

    scan_pc = o3d.geometry.PointCloud()
    map_pc = o3d.geometry.PointCloud()
    slice_pc = o3d.geometry.PointCloud()
    traj_ls = o3d.geometry.LineSet()
    mesh = o3d.geometry.TriangleMesh()

    while True:
        pkt = read_packet(sock)
        if pkt is None:
            break
        header, arrays = pkt
        topic = header["topic"]
        if topic == "frame":
            if "scan" in arrays and not args.no_scan:
                scan_pc.points = o3d.utility.Vector3dVector(
                    arrays["scan"].astype(np.float64)
                )
                scan_pc.paint_uniform_color([0.1, 0.7, 0.9])
                upsert("scan", scan_pc, reset_bbox=header["frame"] == 0)
            if "traj" in arrays and len(arrays["traj"]) > 1:
                t = arrays["traj"].astype(np.float64)
                traj_ls.points = o3d.utility.Vector3dVector(t)
                traj_ls.lines = o3d.utility.Vector2iVector(
                    np.stack(
                        [np.arange(len(t) - 1), np.arange(1, len(t))], 1
                    )
                )
                traj_ls.paint_uniform_color([1.0, 0.2, 0.2])
                upsert("traj", traj_ls)
        elif topic == "neural_points" and not args.no_map:
            map_pc.points = o3d.utility.Vector3dVector(
                arrays["positions"].astype(np.float64)
            )
            if "colors" in arrays:
                map_pc.colors = o3d.utility.Vector3dVector(
                    arrays["colors"].astype(np.float64)
                )
            upsert("map", map_pc)
        elif topic == "mesh" and not args.no_mesh:
            mesh.vertices = o3d.utility.Vector3dVector(
                arrays["vertices"].astype(np.float64)
            )
            mesh.triangles = o3d.utility.Vector3iVector(
                arrays["triangles"].astype(np.int32)
            )
            if "colors" in arrays:
                mesh.vertex_colors = o3d.utility.Vector3dVector(
                    arrays["colors"].astype(np.float64)
                )
            mesh.compute_vertex_normals()
            upsert("mesh", mesh)
        elif topic == "sdf_slice":
            p = arrays["points"].astype(np.float64)
            v = arrays["sdf"]
            c = np.zeros((len(p), 3))
            s = np.clip(v / (np.abs(v).max() + 1e-9), -1, 1)
            c[:, 0] = np.clip(s, 0, 1)
            c[:, 2] = np.clip(-s, 0, 1)
            slice_pc.points = o3d.utility.Vector3dVector(p)
            slice_pc.colors = o3d.utility.Vector3dVector(c)
            upsert("sdf_slice", slice_pc)
        if not vis.poll_events():
            break
        vis.update_renderer()

    vis.destroy_window()


if __name__ == "__main__":
    main()
