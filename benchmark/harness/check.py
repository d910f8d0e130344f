"""The comparison that decides ``correct``.

The plain reference (``benchmark/plainref``: the frame step on the plain
paths, importing nothing of the system under test) works out again what
the timed path produced:

- the start: frame 0 from the reference's own initial state, made from
  the seed as the system makes its own (the decoders' weights included),
  against the system's state after frame 0 (``start_points``: neural
  points that differ; ``start_sdf``: the widest gap of the two maps'
  decoded SDF at points drawn from the seed around the frame's scan);
- each sampled frame (one of the warm-up frames and some of the window's,
  drawn from the seed), one step ahead from the system's own state before
  it, on the same frame: ``pose``, the widest gap between the entries of
  the system's pose and the reference's tracked pose ([4,4], metres and
  rotation entries); then, with the system's pose handed to the stages
  after tracking, ``points`` (neural points that differ), ``sdf`` (the
  widest gap of the decoded SDF at points drawn around the frame's scan,
  both maps decoded by the reference) and, where the configuration runs
  the dynamic filter, ``filter`` (the gap between the counts of points it
  keeps).

Following the system step by step from its own state is the only
comparison that a chaotic loop allows: two correct runs that round
differently part within tens of frames. The start check covers what the
steps skip (the state's making and frame 0's general mapping body).
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _probe_points(ref, scan: np.ndarray, pose: np.ndarray, rng, n: int, spread_m: float,
                  device) -> torch.Tensor:
    """``n`` points drawn from ``rng`` around the frame's scan in the world
    frame: scan points moved by a uniform offset of up to ``spread_m``."""
    T = ref.T_imu_lidar
    pts = scan.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
    pts = pts @ pose[:3, :3].T + pose[:3, 3]
    pick = rng.integers(0, len(pts), n)
    pts = pts[pick] + rng.uniform(-spread_m, spread_m, (n, 3))
    return torch.as_tensor(pts, dtype=torch.float32, device=device)


def _point_gap(n_a: int, pos_a: torch.Tensor, n_b: int, pos_b: torch.Tensor) -> int:
    n = min(n_a, n_b)
    differ = torch.any(pos_a[:n].cpu() != pos_b[:n].cpu(), dim=-1)
    return abs(n_a - n_b) + int(differ.sum())


def _sdf_gap(ref, map_a, mlp_a, map_b, mlp_b, pts, note: str) -> float:
    sa, na = ref.sdf(map_a, mlp_a, pts)
    sb, nb = ref.sdf(map_b, mlp_b, pts)
    live = (na > 0) | (nb > 0)
    if not bool(live.any()):
        return 0.0
    gap = torch.abs(sa - sb)[live].double()
    q = torch.quantile(gap, torch.tensor([0.5, 0.99, 0.999], dtype=gap.dtype, device=gap.device))
    print(f"# {note}: sdf gap over {int(live.sum())} points: max {float(gap.max()):.3e}, "
          f"p99.9 {float(q[2]):.3e}, p99 {float(q[1]):.3e}, median {float(q[0]):.3e}",
          file=sys.stderr)
    return float(gap.max())


def compare(cfg_doc: dict, seq, n_frames: int, start: dict, samples: list, seed: int,
            probe: dict, device) -> dict:
    """The numbers compared, each as a float: ``start_points``,
    ``start_sdf``, ``pose``, ``points``, ``sdf`` and, with the dynamic
    filter on, ``filter``. ``start`` is the system's state after frame 0
    (``leaves``, ``gen``); ``samples`` are (frame, state before, outputs
    after)."""
    from plainref.config import Config
    from plainref.driver import Reference, full_precision

    full_precision()
    cfg = Config.from_dict(cfg_doc)
    ref = Reference(cfg, n_frames, device)
    rng = np.random.default_rng([seed, 2])
    n_probe, spread = int(probe["points"]), float(probe["spread_m"])
    out = {}
    with torch.no_grad():
        st0 = ref.init_state(seq.poses[0][:3, :3], seq.poses[0][:3, 3], seq.velocity0)
        mine, _, _, _ = ref.frame(st0, 0, seq.scans[0], seq.imu[0], seq.point_ts[0])
        del st0
        theirs = ref.state_from_leaves(start["leaves"], start["gen"])
        out["start_points"] = _point_gap(int(theirs.map_state.count), theirs.map_state.positions,
                                         int(mine.map_state.count), mine.map_state.positions)
        pts = _probe_points(ref, seq.scans[0], seq.poses[0], rng, n_probe, spread, device)
        out["start_sdf"] = _sdf_gap(ref, theirs.map_state, theirs.mlp, mine.map_state,
                                    mine.mlp, pts, "frame 0")
        del mine, theirs
        gaps = {"pose": 0.0, "points": 0, "sdf": 0.0}
        if cfg.dynamic_filter_on:
            gaps["filter"] = 0
        for fid, before, after in samples:
            state = ref.state_from_leaves(before["leaves"], before["gen"])
            del before
            pose = after["pose"].double().numpy()
            new, _, filtered, tracked = ref.frame(
                state, fid, seq.scans[fid], seq.imu[fid], seq.point_ts[fid],
                pose_override=pose)
            del state
            pose_gap = float(np.max(np.abs(tracked.double().cpu().numpy() - pose)))
            gaps["pose"] = max(gaps["pose"], pose_gap)
            n_sys, n_ref = after["count"], int(new.map_state.count)
            gaps["points"] = max(gaps["points"], _point_gap(
                n_sys, after["positions"], n_ref, new.map_state.positions))
            # the system's map: the reference's points with the system's features
            feats = new.map_state.geo_feats.clone()
            n = min(n_sys, n_ref)
            feats[:n] = after["geo_feats"][:n].to(device)
            sys_map = new.map_state._replace(geo_feats=feats)
            sys_mlp = type(new.mlp)(*[
                [t.to(device) for t in after["mlp"][:len(new.mlp.weights)]],
                [t.to(device) for t in after["mlp"][len(new.mlp.weights):2 * len(new.mlp.weights)]],
                after["mlp"][-2].to(device), after["mlp"][-1].to(device)])
            pts = _probe_points(ref, seq.scans[fid], pose, rng, n_probe, spread, device)
            gaps["sdf"] = max(gaps["sdf"], _sdf_gap(ref, sys_map, sys_mlp, new.map_state,
                                                    new.mlp, pts, f"frame {fid}"))
            if "filter" in gaps:
                kept_ref = int(filtered[1]) if filtered is not None else -1
                gaps["filter"] = max(gaps["filter"], abs(after["filtered"] - kept_ref))
                print(f"# frame {fid}: the filter keeps {after['filtered']} (reference "
                      f"{kept_ref})", file=sys.stderr)
            print(f"# frame {fid}: pose gap {pose_gap:.3e}; neural points {n_sys} "
                  f"(reference {n_ref})", file=sys.stderr)
            del new, sys_map, feats
        out.update(gaps)
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or a limit without a number, is not
    correct."""
    rows, ok = [], True
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name)
        limit = limits.get(name, {}).get("limit")
        good = value is not None and limit is not None and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
