"""The reader of ``prep_graph_share``: the program's tracked frames whose
map prep ran as graph replays over the traced frames, and None where the
program counts no replays or the counters are not the traced frames'."""

import types

import pytest

from harness import spec

from clid_slam_torch.utils import observability as obs

READ = spec.load_reader("prep_graph_share")
TRACE = types.SimpleNamespace(frames=10)


@pytest.mark.parametrize("counts, want", [
    ({"frames": 10, "prep.graph_frames": 10}, 1.0),
    ({"frames": 10, "prep.graph_frames": 4}, 0.4),
    ({"frames": 10, "track.iters": 25}, None),  # a program without the prep graphs
    ({"frames": 11, "prep.graph_frames": 11}, None),  # other frames
    ({}, None),  # nothing traced
])
def test_prep_graph_share_reads_the_replayed_frames_over_the_frames(counts, want, monkeypatch):
    monkeypatch.setattr(obs, "counters", lambda: dict(counts))
    assert READ(TRACE) == want
