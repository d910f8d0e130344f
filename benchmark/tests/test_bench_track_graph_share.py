"""The reader of ``track_graph_share``: the program's graph replays over
its IESEKF iterations in the traced frames, and None where the program
counts no replays or the counters are not the traced frames'."""

import types

import pytest

from harness import spec

from clid_slam_torch.utils import observability as obs

READ = spec.load_reader("track_graph_share")
TRACE = types.SimpleNamespace(frames=10)


@pytest.mark.parametrize("counts, want", [
    ({"frames": 10, "track.iters": 25, "track.graph_iters": 25}, 1.0),
    ({"frames": 10, "track.iters": 40, "track.graph_iters": 10}, 0.25),
    ({"frames": 10, "track.iters": 25}, None),  # a program without the graph
    ({"frames": 11, "track.iters": 25, "track.graph_iters": 25}, None),  # other frames
    ({}, None),  # nothing traced
])
def test_track_graph_share_reads_the_replays_over_the_iterations(counts, want, monkeypatch):
    monkeypatch.setattr(obs, "counters", lambda: dict(counts))
    assert READ(TRACE) == want
