"""The reader of ``frame_mfu_with_replays``: ``frame_mfu`` plus the
operations of the tracker's graph replays that the program counts, and
None where the program counts no replays or the counters are not the
traced frames'."""

import types

import pytest

from harness import spec

from clid_slam_torch.utils import observability as obs

READ = spec.load_reader("frame_mfu_with_replays")
# frame_mfu: K1's 3e8 and the profiler's 1e8 operations over 0.5 s at 1e10 a second, 8 %
TRACE = types.SimpleNamespace(frames=10, window_s=0.5, k1=[{"flops": 1e8}, {"flops": 2e8}],
                              matmul_flops=1e8, peak={"f32_flops": 1e10})


@pytest.mark.parametrize("counts, want", [
    ({"frames": 10, "track.graph_flops": 5e8}, 18.0),
    ({"frames": 10, "track.graph_flops": 0}, 8.0),  # no replay in the traced frames
    ({"frames": 10, "track.iters": 25}, None),  # a program without the graph
    ({"frames": 11, "track.graph_flops": 5e8}, None),  # other frames
    ({}, None),  # nothing traced
])
def test_frame_mfu_with_replays_adds_the_replays_operations(counts, want, monkeypatch):
    monkeypatch.setattr(obs, "counters", lambda: dict(counts))
    got = READ(TRACE)
    assert got == want if want is None else got == pytest.approx(want, rel=1e-12)
