"""The sequence generator: the same seed gives the same inputs, the cast
leaves out only what lies beyond the sensor's reach, and the IMU rows
agree with the trajectory."""

import json
import os

import numpy as np
import pytest
import torch

from harness import generator

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENSOR = {"beams": 8, "columns": 64, "vertical_fov_deg": 33.2, "min_range_m": 0.3,
          "max_range_m": 30.0}


def traffic(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


def test_the_same_seed_gives_the_same_inputs():
    t = traffic("walk_pedestrians")
    a = generator.generate(SENSOR, t, np.eye(4), 2147483659, "cpu", n_frames=6)
    b = generator.generate(SENSOR, t, np.eye(4), 2147483659, "cpu", n_frames=6)
    c = generator.generate(SENSOR, t, np.eye(4), 2147483660, "cpu", n_frames=6)
    for x, y in zip(a.scans + a.point_ts + a.imu, b.scans + b.point_ts + b.imu):
        assert np.array_equal(x, y)
    assert np.array_equal(a.poses, b.poses)
    assert not np.allclose(a.poses[0], c.poses[0])


def test_far_primitives_are_left_out_only_beyond_reach():
    t = traffic("walk")
    layout = generator.large_world(t["world"])
    f32 = dict(dtype=torch.float32)
    bx = layout["boxes"]
    world = {"pillars": torch.as_tensor(layout["pillars"], **f32),
             "boxes": torch.as_tensor(bx, **f32),
             "box_lo": torch.as_tensor(np.stack([bx[:, 0] - bx[:, 2], bx[:, 1] - bx[:, 3],
                                                 bx[:, 4]], -1), **f32),
             "box_hi": torch.as_tensor(np.stack([bx[:, 0] + bx[:, 2], bx[:, 1] + bx[:, 3],
                                                 bx[:, 5]], -1), **f32)}
    origins = torch.tensor([[32.0, 0.0, 0.0], [31.9, 1.0, 0.0]])
    d = torch.randn(4096, 3, generator=torch.Generator().manual_seed(0))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = origins[torch.arange(4096) % 2]
    w = t["world"]
    args = (float(w["room_radius_m"]), float(w["floor_z_m"]), float(w["ceil_z_m"]))
    reach = 20.0
    near = generator.near(world, origins, reach)
    assert 0 < near["pillars"].shape[0] < world["pillars"].shape[0]
    full = generator.raycast(o, d, world, *args)
    cut = generator.raycast(o, d, near, *args)
    inside = full < reach
    assert torch.equal(full[inside], cut[inside])
    assert bool((cut[~inside] >= reach).all())


@pytest.mark.parametrize("carry", [{}, {"yaw_swing_deg": 60.0, "yaw_swing_hz": 0.5,
                                      "bob_m": 0.1, "bob_hz": 2.0}])
def test_imu_rows_integrate_to_the_trajectory(carry):
    t = traffic("walk")
    t["motion"].update(carry)
    seq = generator.generate(SENSOR, t, np.eye(4), 7, "cpu", n_frames=4)
    assert seq.imu[0].shape == (0, 7) and seq.imu[1].shape == (t["motion"]["imu_rows"], 7)
    dt = t["motion"]["frame_dt_s"]
    for i in (1, 2, 3):
        # the yaw rate over a frame turns the pose by the frame's rotation
        yaw = np.sum(seq.imu[i][:, 0] * seq.imu[i][:, 6])
        rel = seq.poses[i - 1][:3, :3].T @ seq.poses[i][:3, :3]
        assert np.isclose(yaw, np.arctan2(rel[1, 0], rel[0, 0]), atol=1e-4)
    step = np.linalg.norm(seq.poses[1][:2, 3] - seq.poses[0][:2, 3]) / dt
    assert np.isclose(step, t["motion"]["speed_m_s"], rtol=1e-3)
    assert np.isclose(np.linalg.norm(seq.velocity0[:2]), t["motion"]["speed_m_s"])
    for ts in seq.point_ts:
        assert ts.min() >= 0.0 and ts.max() <= 1.0
