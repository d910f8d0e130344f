"""The benchmark's LiDAR-inertial sequence generator, in PyTorch on the card.

A copy of ``clid_slam_torch/pipeline/synthetic.py``'s analytic world and
ray caster (``SyntheticWorld.raycast``, lines 33-86; ``large_world``,
lines 180-232; the IMU rows of ``generate_sequence``, lines 300-324),
rewritten so that a whole sequence is cast on the device in a few large
calls, with three changes that a spinning sensor on a walking platform
needs:

- every column of a sweep fires at its own time, from the sensor's pose
  at that time, and carries that time as the point's timestamp (the sweep
  spans one frame, centred on the frame's pose, as the deskew of the
  system under test assumes);
- the sensor sits at ``T_imu_lidar`` from the IMU whose pose the
  trajectory gives, and the scan is returned in the sensor's frame;
- pedestrians are finite-height cylinders walking straight lines across
  the path, each crossing a stretch of the path ahead of the platform.

Everything random is drawn from the run's seed; the world's layout is
drawn from the traffic's own ``world.seed``, so that every run sees the
same world and a seed changes where the walk starts, the sensor noise and
the pedestrians: the same work in another order.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

G = 9.81
_FAR = float("inf")
CHUNK_RAYS = 1 << 21  # rays cast together: a few GB of scratch on the card


@dataclass
class Sequence:
    """A generated sequence, handed over as host arrays."""

    poses: np.ndarray  # [N,4,4] f64, the IMU's ground-truth poses at frame times
    scans: List[np.ndarray]  # [M_i,3] f32 points in the sensor's frame
    point_ts: List[np.ndarray]  # [M_i] f32 firing time in the sweep, 0..1
    imu: List[np.ndarray]  # [K,7] (dt, acc, gyro) rows before each frame (empty for 0)
    velocity0: np.ndarray  # [3] world velocity at frame 0


def large_world(world: dict) -> dict:
    """Pillars [n,3] (cx, cy, r) and boxes [m,6] (cx, cy, hx, hy, z0, z1)
    of the large hall, drawn as ``synthetic.large_world`` draws them from
    ``world["seed"]``."""
    rng = np.random.default_rng(int(world["seed"]))
    room = float(world["room_radius_m"])
    annulus = tuple(world["feature_annulus_m"])
    path_r = float(world["path_radius_m"])
    floor_z = float(world["floor_z_m"])
    pillars = []
    for i in range(int(world["pillars"])):
        r = rng.uniform(*annulus) if i % 2 == 0 else rng.uniform(6.0, room - 4.0)
        th = rng.uniform(0, 2 * np.pi)
        pillars.append((r * np.cos(th), r * np.sin(th), rng.uniform(0.4, 2.2)))
    boxes = []
    tries, n_boxes = 0, int(world["boxes"])
    while len(boxes) < n_boxes and tries < n_boxes * 40:
        tries += 1
        r = rng.uniform(*annulus) if len(boxes) % 2 == 0 else rng.uniform(8.0, room - 6.0)
        th = rng.uniform(0, 2 * np.pi)
        hx, hy = rng.uniform(1.0, 3.0), rng.uniform(1.0, 3.0)
        cx, cy = r * np.cos(th), r * np.sin(th)
        if abs(np.hypot(cx, cy) - path_r) < 3.5 + float(np.hypot(hx, hy)):
            continue
        boxes.append((cx, cy, hx, hy, floor_z, floor_z + rng.uniform(2.0, 5.5)))
    return {"pillars": np.array(pillars, np.float64).reshape(-1, 3),
            "boxes": np.array(boxes, np.float64).reshape(-1, 6)}


def ring_state(t, theta0: float, radius: float, speed: float, height: float,
               motion: dict = None):
    """The IMU's state on the ring at times ``t`` [N] (f64 tensor): (R
    [N,3,3] with yaw along the motion, p [N,3], body rate [N,3], specific
    force in the body frame [N,3]). Constant speed round the ring; a
    handheld carry adds, where ``motion`` gives them, a yaw swing
    (``yaw_swing_deg`` at ``yaw_swing_hz``) and a vertical bob (``bob_m``
    at ``bob_hz``), both sinusoidal."""
    motion = motion or {}
    w = speed / radius
    th = theta0 + w * t
    c, s = torch.cos(th), torch.sin(th)
    z, o = torch.zeros_like(t), torch.ones_like(t)
    yaw, yaw_rate, height_t, z_acc = th + math.pi / 2, torch.full_like(t, w), height + z, z
    if motion.get("yaw_swing_deg"):
        a, f = math.radians(float(motion["yaw_swing_deg"])), 2 * math.pi * float(motion["yaw_swing_hz"])
        yaw = yaw + a * torch.sin(f * t)
        yaw_rate = yaw_rate + a * f * torch.cos(f * t)
    if motion.get("bob_m"):
        b, f = float(motion["bob_m"]), 2 * math.pi * float(motion["bob_hz"])
        height_t = height_t + b * torch.sin(f * t)
        z_acc = -b * f * f * torch.sin(f * t)
    p = torch.stack([radius * c, radius * s, height_t], -1)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    R = torch.stack([torch.stack([cy, -sy, z], -1), torch.stack([sy, cy, z], -1),
                     torch.stack([z, z, o], -1)], -2)
    pdd = torch.stack([-w * w * radius * c, -w * w * radius * s, z_acc], -1)
    grav = torch.tensor([0.0, 0.0, -G], dtype=t.dtype, device=t.device)
    acc = torch.einsum("nji,nj->ni", R, pdd - grav)
    gyro = torch.stack([z, z, yaw_rate], -1)
    return R, p, gyro, acc


def beam_directions(sensor: dict, device) -> torch.Tensor:
    """[cols, beams, 3] unit directions in the sensor's frame: beams spread
    evenly over the vertical field, columns over the full turn."""
    half = math.radians(float(sensor["vertical_fov_deg"])) / 2
    el = torch.linspace(-half, half, int(sensor["beams"]), dtype=torch.float64, device=device)
    az = torch.linspace(-math.pi, math.pi, int(sensor["columns"]) + 1, dtype=torch.float64,
                        device=device)[:-1]
    A, E = torch.meshgrid(az, el, indexing="ij")
    return torch.stack([torch.cos(E) * torch.cos(A), torch.cos(E) * torch.sin(A),
                        torch.sin(E)], -1)


def _cylinders(o, d, a, cyl, z_lo, z_hi):
    """Nearest entry distance of rays (o [N,3], d [N,3], a = dx² + dy² [N])
    into vertical cylinders cyl [N or 1, C, 3] (cx, cy, r) between heights
    z_lo and z_hi (floats, or [N or 1, C]): [N]."""
    if cyl.shape[1] == 0:
        return torch.full_like(a, _FAR)
    ox = o[:, None, 0] - cyl[..., 0]
    oy = o[:, None, 1] - cyl[..., 1]
    hb = ox * d[:, None, 0] + oy * d[:, None, 1]  # half of the quadratic's b
    disc = hb * hb - a[:, None] * (ox * ox + oy * oy - cyl[..., 2] ** 2)
    t1 = (-hb - torch.sqrt(torch.clamp(disc, min=0))) / a[:, None]
    zhit = o[:, None, 2] + t1 * d[:, None, 2]
    hit = (disc > 0) & (t1 > 1e-6) & (zhit > z_lo) & (zhit < z_hi)
    return torch.where(hit, t1, _FAR).min(dim=1).values


def raycast(o, d, world: dict, room: float, floor_z: float, ceil_z: float, peds=None):
    """Distances [N] along unit directions d [N,3] from origins o [N,3] to
    the nearest surface: the hall's wall, floor and ceiling, the pillars,
    the boxes and the pedestrians (``peds`` [N,P,3], their tops at
    ``world["ped_top"]``)."""
    dz = d[:, 2]
    a = torch.clamp(d[:, 0] ** 2 + d[:, 1] ** 2, min=1e-12)
    hb = o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1]
    disc = hb * hb - a * (o[:, 0] ** 2 + o[:, 1] ** 2 - room * room)
    t = (-hb + torch.sqrt(torch.clamp(disc, min=0))) / a
    best = torch.where((disc > 0) & (t > 1e-6), t, _FAR)
    for z0 in (floor_z, ceil_z):
        tz = (z0 - o[:, 2]) / torch.where(dz.abs() > 1e-9, dz, torch.full_like(dz, 1e-9))
        best = torch.minimum(best, torch.where((dz.abs() > 1e-9) & (tz > 1e-6), tz, _FAR))
    best = torch.minimum(best, _cylinders(o, d, a, world["pillars"][None], floor_z, ceil_z))
    bx = world["boxes"]
    if bx.shape[0]:
        inv = 1.0 / torch.where(d.abs() > 1e-12, d, torch.full_like(d, 1e-12))
        ta = (world["box_lo"][None] - o[:, None, :]) * inv[:, None, :]
        tb = (world["box_hi"][None] - o[:, None, :]) * inv[:, None, :]
        tn = torch.minimum(ta, tb).amax(-1)
        tf = torch.maximum(ta, tb).amin(-1)
        best = torch.minimum(best, torch.where((tn <= tf) & (tn > 1e-6), tn, _FAR).amin(1))
    if peds is not None and peds.shape[1]:
        best = torch.minimum(best, _cylinders(o, d, a, peds, floor_z, world["ped_top"]))
    return best


def near(world: dict, origins: torch.Tensor, reach: float) -> dict:
    """``world`` without the pillars and boxes that lie beyond ``reach`` of
    every one of ``origins`` [M,3]: no ray from them can return from
    there."""
    c = origins[:, :2].double().mean(0)
    extent = float(torch.linalg.norm(origins[:, :2].double() - c, dim=-1).max())
    pil, bx = world["pillars"], world["boxes"]
    keep_p = torch.linalg.norm(pil[:, :2].double() - c, dim=-1) - pil[:, 2] < reach + extent
    keep_b = (torch.linalg.norm(bx[:, :2].double() - c, dim=-1)
              - torch.linalg.norm(bx[:, 2:4].double(), dim=-1) < reach + extent)
    return dict(world, pillars=pil[keep_p], boxes=bx[keep_b], box_lo=world["box_lo"][keep_b],
                box_hi=world["box_hi"][keep_b])


def pedestrian_plan(ped: dict, n_frames: int, frame_dt: float, theta0: float, radius: float,
                    speed: float, rng: np.random.Generator) -> np.ndarray:
    """Straight walks across the path: [count, crossings, 5] rows of (time
    at the crossing point, crossing point x, y, velocity x, y). Walker i
    crosses every ``period_s``, phase-shifted by i/count of it, at the
    point of the ring that the platform reaches ``lead_s`` later, heading
    at an angle drawn from the seed; it is on its line for the period
    around that crossing, so ``count`` walkers are always near the path."""
    count, period = int(ped["count"]), float(ped["period_s"])
    lead_lo, lead_hi = ped["lead_s"]
    t_end = n_frames * frame_dt + period
    n_cross = int(math.ceil(t_end / period)) + 1
    out = np.zeros((count, n_cross, 5))
    w = speed / radius
    for i in range(count):
        for j in range(n_cross):
            tc = (j + i / count) * period
            lead = rng.uniform(lead_lo, lead_hi)
            th = theta0 + w * (tc + lead)
            heading = th + rng.uniform(-np.pi, np.pi)
            out[i, j] = (tc, radius * np.cos(th), radius * np.sin(th),
                         float(ped["speed_m_s"]) * np.cos(heading),
                         float(ped["speed_m_s"]) * np.sin(heading))
    return out


def generate(sensor: dict, traffic: dict, T_imu_lidar: np.ndarray, seed: int, device,
             n_frames: int = None) -> Sequence:
    """The traffic's sequence for this sensor, from ``seed``, cast on
    ``device`` and returned as host arrays."""
    n_frames = int(traffic["frames"] if n_frames is None else n_frames)
    wcfg, motion = traffic["world"], traffic["motion"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    layout = large_world(wcfg)
    bx = layout["boxes"]
    world = {"pillars": torch.as_tensor(layout["pillars"], **f32),
             "boxes": torch.as_tensor(bx, **f32),
             "box_lo": torch.as_tensor(np.stack([bx[:, 0] - bx[:, 2], bx[:, 1] - bx[:, 3],
                                                 bx[:, 4]], -1), **f32),
             "box_hi": torch.as_tensor(np.stack([bx[:, 0] + bx[:, 2], bx[:, 1] + bx[:, 3],
                                                 bx[:, 5]], -1), **f32)}
    room, floor_z, ceil_z = (float(wcfg["room_radius_m"]), float(wcfg["floor_z_m"]),
                             float(wcfg["ceil_z_m"]))
    radius, speed = float(wcfg["path_radius_m"]), float(motion["speed_m_s"])
    height, dt = float(motion["height_m"]), float(motion["frame_dt_s"])
    theta0 = float(rng.uniform(0, 2 * np.pi))
    ped = traffic.get("pedestrians")
    plan = None
    if ped and int(ped["count"]):
        plan = torch.as_tensor(pedestrian_plan(ped, n_frames, dt, theta0, radius, speed, rng),
                               **f64)
        world["ped_top"] = floor_z + float(ped["height_m"])
        ped_r = float(ped["radius_m"])
        period = float(ped["period_s"])
    T_il = torch.as_tensor(np.asarray(T_imu_lidar, np.float64), **f64)
    dirs = beam_directions(sensor, device)  # [cols, beams, 3]
    cols, beams = dirs.shape[0], dirs.shape[1]
    s_col = torch.arange(cols, **f64) / max(cols - 1, 1)  # firing time in the sweep
    rays_frame = cols * beams
    frames_chunk = max(1, CHUNK_RAYS // rays_frame)
    r_min, r_max = float(sensor["min_range_m"]), float(sensor["max_range_m"])
    noise = float(traffic.get("range_noise_m", 0.0))
    pts_parts, ts_parts, counts = [], [], []
    t_cast = time.perf_counter()
    for f0 in range(0, n_frames, frames_chunk):
        fr = torch.arange(f0, min(f0 + frames_chunk, n_frames), **f64)
        nf = fr.shape[0]
        # per column: the IMU's pose at the column's firing time, then the sensor's
        t_col = (fr[:, None] + s_col[None, :] - 0.5) * dt  # [nf, cols]
        R, p, _, _ = ring_state(t_col.reshape(-1), theta0, radius, speed, height, motion)
        R_wl = R @ T_il[:3, :3]
        o_col = p + R @ T_il[:3, 3]
        d_w = torch.einsum("nij,nbj->nbi", R_wl, dirs.repeat(nf, 1, 1))  # [nf*cols, beams, 3]
        o = o_col[:, None, :].expand(-1, beams, -1).reshape(-1, 3).float()
        d = d_w.reshape(-1, 3).float()
        peds = None
        if plan is not None:
            # each walker's position at each column's time, on its current line
            tc = t_col.reshape(-1)
            j = torch.clamp(torch.floor(tc[:, None] / period + 0.5
                                        - torch.arange(plan.shape[0], **f64)[None] / plan.shape[0]),
                            0, plan.shape[1] - 1).long()  # [ncol, count]
            row = plan[torch.arange(plan.shape[0], device=device)[None, :], j]  # [ncol, count, 5]
            ptime = tc[:, None] - row[..., 0]
            px = row[..., 1] + row[..., 3] * ptime
            py = row[..., 2] + row[..., 4] * ptime
            peds = torch.stack([px, py, torch.full_like(px, ped_r)], -1).float()
            peds = peds[:, None].expand(-1, beams, -1, -1).reshape(-1, peds.shape[1], 3)
        rng_t = raycast(o, d, near(world, o_col, r_max), room, floor_z, ceil_z, peds)
        if noise > 0:
            rng_t = rng_t + noise * torch.randn(rng_t.shape, generator=gen, **f32)
        hit = torch.isfinite(rng_t) & (rng_t > r_min) & (rng_t < r_max)
        local = dirs.float().reshape(1, -1, 3).expand(nf, -1, -1).reshape(-1, 3) * rng_t[:, None]
        ts = s_col.float()[:, None].expand(-1, beams).reshape(1, -1).expand(nf, -1).reshape(-1)
        frame_of = torch.arange(nf, device=device).repeat_interleave(rays_frame)
        counts.append(torch.bincount(frame_of[hit], minlength=nf))
        pts_parts.append(local[hit])
        ts_parts.append(ts[hit])
    t_host = time.perf_counter()
    counts = torch.cat(counts).cpu().numpy()
    splits = np.cumsum(counts)[:-1]
    scans = np.split(torch.cat(pts_parts).cpu().numpy(), splits)
    point_ts = np.split(torch.cat(ts_parts).cpu().numpy(), splits)
    del pts_parts, ts_parts

    # ground truth at frame times, and each frame's IMU rows at their midpoints
    t_frames = torch.arange(n_frames, **f64) * dt
    R, p, _, _ = ring_state(t_frames, theta0, radius, speed, height, motion)
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    poses[:, :3, :3] = R.cpu().numpy()
    poses[:, :3, 3] = p.cpu().numpy()
    k = int(motion["imu_rows"])
    t_mid = ((torch.arange(1, n_frames, **f64)[:, None] - 1) * dt
             + (torch.arange(k, **f64)[None] + 0.5) * dt / k)
    _, _, gyro, acc = ring_state(t_mid.reshape(-1), theta0, radius, speed, height, motion)
    rows = torch.cat([torch.full((gyro.shape[0], 1), dt / k, **f64), acc, gyro], -1)
    rows = rows.reshape(n_frames - 1, k, 7).cpu().numpy()
    imu = [np.zeros((0, 7))] + [rows[i] for i in range(n_frames - 1)]
    w = speed / radius
    vel0 = np.array([-np.sin(theta0), np.cos(theta0), 0.0]) * radius * w
    if motion.get("bob_m"):
        vel0[2] = float(motion["bob_m"]) * 2 * math.pi * float(motion["bob_hz"])
    print(f"# cast: rays {time.perf_counter() - t_cast:.3f} s (host part "
          f"{time.perf_counter() - t_host:.3f} s)", file=sys.stderr)
    return Sequence(poses, scans, point_ts, imu, vel0)
