"""The classic mesh's tail held against the JAX package's mesh of the same
map. Not a test; run it on the card's machine, which has the JAX package
for its CPU:

    python tests/torch_mesh_tail.py --out mesh_tail

It writes chip_smoke.py's classic sequence with the ``classic_mesh``
phase's mesh options (``chip_smoke.py:MESH_YAML``), runs the port's classic
CLI on it (the run's own ``mesh.ply`` at ``mc_res_m`` and its
``map_checkpoint.npz``), then both map inspectors on that checkpoint at the
same resolution: the port's on the card, the JAX package's on the CPU
(``JAX_PLATFORMS=cpu``), each in a subprocess. It prints one JSON line: for
each mesh its vertex count and the p50, p90 and p99 of its vertices'
distance to the synthetic room (``chip_smoke.py:surface_distance``); between
the two inspectors' meshes the symmetric Chamfer distance (the mean
nearest-vertex distance, both ways), the share of each side's vertices
farther than 1 cm from the other's, and the share of each side's tail
(vertices over 0.12 m from the room) that lies within 1 cm of the other
side's vertices. Grid points on voxel faces can decode differently in the
two inspectors (JAX's jitted chunk query floors them into the next cell;
ROADMAP C12), so the meshes may part there by a fraction of a cell.

``--out`` gets the written sequence (about 70 MB), the run and both
inspectors' files. ``--checkpoint FILE`` skips the run and inspects FILE;
``--device cpu`` runs the port's side on the CPU (a rehearsal at small
sizes).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TAIL_M = 0.12  # the classic mesh's p90 (ROADMAP C10)
NEAR_M = 0.01


def _inspect(module, ckpt, res, out, env=None, extra=()):
    t0 = time.time()
    cli = subprocess.run([sys.executable, "-m", module, ckpt, "-m", str(res), "-o", out, *extra],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
    if cli.returncode != 0:
        raise SystemExit(f"{module}: rc {cli.returncode}\n{cli.stderr[-3000:]}")
    return time.time() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the run and the meshes")
    ap.add_argument("--checkpoint", default=None, help="inspect this checkpoint instead of a run")
    ap.add_argument("--device", default="cuda", help="the port's device")
    args = ap.parse_args()

    import chip_smoke as cs
    from clid_slam_torch.config import Config
    from clid_slam_torch.pipeline import slam as tslam
    from clid_slam_torch.tools.convert import _read_mesh_ply
    from scipy.spatial import cKDTree

    root = args.out or tempfile.mkdtemp()
    os.makedirs(root, exist_ok=True)
    seq, path, _ = cs.write_small_dataset(os.path.join(root, "data"), 25, True, extra=cs.MESH_YAML)
    res = Config.load(path).mc_res_m
    meshes, out = {}, {"mc_res_m": res, "device": args.device}
    ckpt = args.checkpoint
    if ckpt is None:
        t0 = time.time()
        with cs.captured_systems(tslam.SlamSystem) as seen:
            result = tslam.run_slam(path, device=args.device)
        run = seen[0].run_path
        ckpt = os.path.join(run, "map_checkpoint.npz")
        meshes["run"] = _read_mesh_ply(os.path.join(run, "mesh.ply"))[0]
        out.update(run_s=time.time() - t0, ate_rmse_m=result["ate_rmse_m_noalign"])
    out["port_inspect_s"] = _inspect("clid_slam_torch.tools.inspect_map", ckpt, res,
                                     os.path.join(root, "port"), extra=("--device", args.device))
    out["jax_inspect_s"] = _inspect("clid_slam_tpu.tools.inspect_map", ckpt, res,
                                    os.path.join(root, "jax"),
                                    env=dict(os.environ, JAX_PLATFORMS="cpu"))
    for side in ("port", "jax"):
        meshes[side] = _read_mesh_ply(os.path.join(root, side, "mesh.ply"))[0]
    for name, v in meshes.items():
        out[name] = cs.distance_stats(seq.world, v)
    pv, jv = meshes["port"], meshes["jax"]
    to_jax, to_port = cKDTree(jv).query(pv)[0], cKDTree(pv).query(jv)[0]
    tail_p = cs.surface_distance(seq.world, pv) > TAIL_M
    tail_j = cs.surface_distance(seq.world, jv) > TAIL_M
    out["port_vs_jax"] = {
        "chamfer_m": float(0.5 * (to_jax.mean() + to_port.mean())),
        "max_port_to_jax_m": float(to_jax.max()), "max_jax_to_port_m": float(to_port.max()),
        "port_far_share": float((to_jax > NEAR_M).mean()),
        "jax_far_share": float((to_port > NEAR_M).mean()),
        "port_tail_vertices": int(tail_p.sum()), "jax_tail_vertices": int(tail_j.sum()),
        "port_tail_near_jax_share": float((to_jax[tail_p] <= NEAR_M).mean()) if tail_p.any() else None,
        "jax_tail_near_port_share": float((to_port[tail_j] <= NEAR_M).mean()) if tail_j.any() else None,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
