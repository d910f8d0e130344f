"""The comparison that decides ``correct``: a sound run passes it, and the
control and every fault that a cell can have fail it. The runs skip the
harness's look for a card and drive the rest of a run on the CPU at a
tiny size (``tiny.py``), with the timed path broken underneath."""

import contextlib

import pytest
import torch

from control import lower_precision
from tiny import run_tiny


@pytest.mark.parametrize("workload", ["ncd128.walk", "quad.walk"])
def test_a_sound_run_is_correct(workload):
    res = run_tiny(workload)
    assert res["correct"], res["checks"]
    assert res["frames"] > 0 and res["failed"] == 0
    names = {n for n, _, _ in res["checks"]}
    assert {"pose", "sdf", "points", "start_sdf", "start_points"} <= names
    assert ("filter" in names) == (workload == "quad.walk")


@contextlib.contextmanager
def fault(kind):
    """The system's frame step broken in one way."""
    from clid_slam_torch.pipeline import streaming

    orig = streaming.StreamingSlam.process_frame

    def unchanged(self, frame_id, points=None, imu_window=None, point_ts=None, draws=None):
        # the step returns its state unchanged (after frame 0)
        if frame_id == 0:
            return orig(self, frame_id, points, imu_window, point_ts, draws)
        self.processed = frame_id + 1

    def half_scan(self, frame_id, points=None, imu_window=None, point_ts=None, draws=None):
        # half of the frame's points left out
        return orig(self, frame_id, points[::2], imu_window,
                    None if point_ts is None else point_ts[::2], draws)

    def altered(self, frame_id, points=None, imu_window=None, point_ts=None, draws=None):
        # the answer altered where it is produced: the pose, by a millimetre
        orig(self, frame_id, points, imu_window, point_ts, draws)
        self.state.odom_poses[frame_id, 0, 3] += 1e-3

    patched = {"unchanged": unchanged, "half_scan": half_scan, "altered": altered}
    if kind == "mapping_skipped":
        # the mapping loop returns its inputs: the map never learns
        from clid_slam_torch.mapping import mapper

        loop = mapper.map_loop
        mapper.map_loop = lambda f0, w0, encw0, label_op, wsel, wtap, enctapw, vd, mlp, *a, **k: (
            f0, mlp, torch.zeros(2, device=f0.device))
        try:
            yield
        finally:
            mapper.map_loop = loop
        return
    streaming.StreamingSlam.process_frame = patched[kind]
    try:
        yield
    finally:
        streaming.StreamingSlam.process_frame = orig


@pytest.mark.parametrize("kind", ["unchanged", "half_scan", "altered", "mapping_skipped"])
def test_a_fault_is_not_correct(kind):
    # the window closes after the sampled frames: a step that does nothing
    # would run through every frame cast within a window of seconds
    with fault(kind):
        res = run_tiny("quad.walk", seconds=0.0)
    assert not res["correct"], res["checks"]


def test_the_bf16_control_is_not_correct():
    with lower_precision("bf16"):
        res = run_tiny("ncd128.walk", seconds=0.0)
    assert not res["correct"], res["checks"]
    failing = [n for n, v, lim in res["checks"] if v > lim]
    assert failing


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["ncd128.walk", "quad.walk"])
def test_the_tf32_control_is_not_correct_on_the_card(card, workload):
    import time

    from harness import cell, spec
    from tiny import FRAMES, TINY

    with lower_precision("tf32"):
        res = cell.run(spec.find_cell(workload), 2147483659, 0.5, False, card,
                       time.perf_counter(), overrides=TINY, n_frames=FRAMES)
    assert not res["correct"], res["checks"]
