"""The spans and counters inside the port's streaming frame step
(``clid_slam_torch/utils/observability.py``), at a tiny size on the CPU:

- every top-level ``frame.*`` span, and every nested ``frame.<stage>.<part>``
  span inside its parent, appears under ``torch.profiler`` in each traced
  frame; no two top-level spans overlap; each carries the frame id;
- without a profiler, ``span`` never reaches ``record_function`` and the
  counters stay empty;
- ``track.iters`` is the sum of the traced frames' ``track_iters``, and
  ``map.steps`` the mapping steps the loop ran, on the fused kernel's path
  and on the autograd loop; no ``syncs``, no ``track.graph_iters`` (the
  tracker's graph replays) and no prep or predict replays are counted off
  the card;
- poses, map, pool and decoders are bit for bit the same with tracing on
  and off;
- each of the benchmark's readers of these spans and counters
  (``benchmark/metrics/``) returns its value from a hand-built trace and
  counter snapshot, and None where there is nothing to read.

One test, marked ``gpu``, runs a frame on the card under the profiler: it
counts the host's syncs, and the sync debug mode is off afterwards; every
IESEKF iteration there is a graph replay, and so are predict and
bookkeep. This
file imports neither JAX nor the JAX package.
"""

import contextlib
import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clid_slam_torch.config import Config
from clid_slam_torch.pipeline import streaming
from clid_slam_torch.pipeline.streaming import StreamingSlam
from clid_slam_torch.pipeline.synthetic import generate_sequence
from clid_slam_torch.utils import observability as obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 4  # frame 0 untraced, frames 1-3 traced
TOP = ["frame.ingest", "frame.upload", "frame.predict", "frame.track", "frame.bookkeep",
       "frame.prep", "frame.iters", "frame.map"]
NESTED = {"frame.track.candidates": "frame.track", "frame.track.iter": "frame.track",
          "frame.prep.local_map": "frame.prep", "frame.prep.sample": "frame.prep",
          "frame.prep.insert": "frame.prep", "frame.prep.pool": "frame.prep",
          "frame.map.cache": "frame.map"}
# the fused kernel's path (its plain version off the card) and the autograd loop
CONFIGS = {"k1": {}, "autograd": dict(mlp_leaky_relu=True)}
# the mapping loops, each of which takes one gradient a step: the autograd
# loop's and the fused kernel's plain version
MAP_LOOPS = {"adam_steps", "map_loop_reference"}
# added to frames 1-3's adaptive step counts (10 here) in both runs, so that
# the count differs frame to frame and the last passes the loop's cap of 20
ITER_OFFSETS = (-3, 4, 15)


def _config(**overrides) -> Config:
    c = Config()
    for k, v in {**dict(
        voxel_size_m=0.3, search_alpha=0.5, local_voxel_size_m=0.15, vox_down_m=0.08,
        source_vox_down_m=0.4, min_range=0.5, max_range=30.0, max_z=30.0, bs=4096,
        bs_new_sample=512, iters=10, init_iter_ratio=2, reg_iter_n=20, freeze_after_frame=6,
        loss_weight_on=True, map_capacity=1 << 15, map_hash_size=1 << 17,
        local_map_capacity=1 << 16, local_map_hash_size=1 << 17,
        max_scan_points=1 << 13, max_source_points=1 << 11, pool_capacity=1 << 18,
    ), **overrides}.items():
        setattr(c, k, v)
    c._derive()
    c.diff_travel_dist_local = 1e9
    return c


def _system(cfg, device="cpu"):
    seq = generate_sequence(n_frames=N_FRAMES, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)
    system = StreamingSlam(cfg, total_frames=8, device=device)
    w = 2 * np.pi / 20.0
    system.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3],
                     vel=seq.poses[0][:3, :3] @ np.array([3.0 * w, 0, 0]))
    return system, seq


def _frame(system, seq, i):
    system.process_frame(i, seq.scans[i], seq.imu_windows[i])


def _varied_iters():
    """``adaptive_iters`` moved by ``ITER_OFFSETS``, one a call."""
    adaptive_iters, offsets = streaming.adaptive_iters, iter(ITER_OFFSETS)
    return lambda *a: adaptive_iters(*a) + next(offsets)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    """The same frames untraced and traced (frames 1-3 under the profiler),
    with what each run saw."""
    cfg = _config(**CONFIGS[request.param])
    obs.reset_counters()
    plain, seq = _system(cfg)
    reached = []
    _frame(plain, seq, 0)
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(streaming, "adaptive_iters", _varied_iters())
        mpatch.setattr(obs, "record_function",
                       lambda *a: reached.append(a) or contextlib.nullcontext())
        for i in range(1, N_FRAMES):
            _frame(plain, seq, i)
    untraced_counters = obs.counters()

    traced, _ = _system(cfg)
    _frame(traced, seq, 0)
    steps, spans = [], []
    record_function = obs.record_function
    grad = torch.autograd.grad

    def recording_grad(*a, **kw):
        caller = sys._getframe(1).f_code.co_name
        if caller in MAP_LOOPS:
            steps.append(caller)
        return grad(*a, **kw)

    def recording_span(name, args=None):
        spans.append((name, args))
        return record_function(name, args)

    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(streaming, "adaptive_iters", _varied_iters())
        mpatch.setattr(torch.autograd, "grad", recording_grad)
        mpatch.setattr(obs, "record_function", recording_span)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(1, N_FRAMES):
                _frame(traced, seq, i)
    events = [(e.start_ns(), e.end_ns(), e.name())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("frame.")]
    return types.SimpleNamespace(
        cfg=cfg, plain=plain, traced=traced, reached=reached,
        untraced_counters=untraced_counters, counters=obs.counters(), events=events,
        spans=spans, steps=steps)


def _ranges(runs, name):
    return sorted((lo, hi) for lo, hi, n in runs.events if n == name)


@pytest.mark.parametrize("name", TOP + sorted(NESTED))
def test_each_span_appears_in_each_traced_frame_inside_its_parent(runs, name):
    found = _ranges(runs, name)
    assert len(found) >= N_FRAMES - 1, (name, len(found))
    if name in NESTED:
        parents = _ranges(runs, NESTED[name])
        for lo, hi in found:
            assert any(plo <= lo and hi <= phi for plo, phi in parents), name


def test_top_level_spans_neither_overlap_nor_nest(runs):
    top = sorted((lo, hi, n) for lo, hi, n in runs.events if n.count(".") == 1)
    assert {n for _, _, n in top} == set(TOP)
    for (lo, hi, n), (lo2, hi2, n2) in zip(top, top[1:]):
        assert hi <= lo2, (n, n2)


def test_top_level_spans_carry_the_frame_id(runs):
    top = [(n, a) for n, a in runs.spans if n.count(".") == 1]
    assert {n for n, _ in top} == set(TOP)
    ids = {a for _, a in top}
    assert ids == {str(i) for i in range(1, N_FRAMES)}
    assert all(a is None for n, a in runs.spans if n.count(".") == 2)


def test_untraced_spans_skip_the_profiler_and_count_nothing(runs):
    assert not obs.tracing()
    assert runs.reached == []
    assert runs.untraced_counters == {}


def test_iteration_counter_matches_the_frames_track_iters(runs):
    per_frame = runs.traced.sync()["track_iters"]
    assert runs.counters["frames"] == N_FRAMES - 1
    assert runs.counters["track.iters"] == int(per_frame[1:N_FRAMES].sum()) > 0
    assert len(_ranges(runs, "frame.track.iter")) == runs.counters["track.iters"]


def test_mapping_step_counter_is_the_steps_the_loop_ran(runs):
    # the steps the mapping loop took, one gradient each, in the traced frames:
    # 7, 14 and 20 (25 capped)
    assert len(set(runs.steps)) == 1
    assert runs.counters["map.steps"] == len(runs.steps) > 0


def test_no_syncs_are_counted_off_the_card(runs):
    assert not any(k.startswith("syncs") for k in runs.counters)


def test_no_graph_replays_are_counted_off_the_card(runs):
    # CPU tensors take the tracker's eager loop
    assert runs.counters["track.iters"] > 0 and "track.graph_iters" not in runs.counters


def test_no_prep_replays_are_counted_off_the_card(runs):
    # CPU tensors take the eager prep
    assert runs.counters["frames"] > 0 and "prep.graph_frames" not in runs.counters


def test_no_predict_replays_are_counted_off_the_card(runs):
    # CPU tensors take the eager predict and bookkeep
    assert runs.counters["frames"] > 0 and "predict.graph_frames" not in runs.counters


def test_tracing_changes_no_result(runs):
    a, b = runs.plain.state.leaves(), runs.traced.state.leaves()
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), i
        else:
            assert torch.equal(x.get_state(), y.get_state()), i


def test_mapping_steps_a_device_scalar_is_read_with_the_counters():
    obs.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        obs.count("map.steps", torch.tensor(7, dtype=torch.int32))
        obs.count("map.steps", 3)
    obs.count("map.steps", 100)  # not tracing: not counted
    assert obs.counters() == {"map.steps": 10}
    obs.reset_counters()
    assert obs.counters() == {}


def test_a_deferred_count_is_called_when_the_counters_are_read():
    # a function counted while tracing runs when counters() is read, after
    # the traced frames, once; untraced, it is neither kept nor called
    calls = []

    def later(n):
        calls.append(n)
        return n

    obs.reset_counters()
    obs.count("graph.flops", lambda: later(7))
    with profile(activities=[ProfilerActivity.CPU]):
        obs.count("graph.flops", lambda: later(5))
        obs.count("graph.flops", lambda: later(6))
        obs.count("graph.flops", 1)
    assert calls == []
    assert obs.counters() == {"graph.flops": 12} and calls == [5, 6]
    assert obs.counters() == {"graph.flops": 12} and calls == [5, 6]
    with profile(activities=[ProfilerActivity.CPU]):
        obs.count("graph.flops", lambda: later(9))
    obs.reset_counters()
    assert obs.counters() == {} and calls == [5, 6]


def _reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"trace_test_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


HOST = {"frame.ingest": 4.0, "frame.upload": 1.5, "frame.predict": 2.0, "frame.track": 10.0,
        "frame.track.iter": 8.0, "frame.track.candidates": 1.0, "frame.bookkeep": 3.0,
        "frame.prep": 20.0, "frame.prep.local_map": 5.0, "frame.prep.sample": 6.0,
        "frame.prep.insert": 2.5, "frame.prep.pool": 4.5, "frame.iters": 0.5,
        "frame.map": 9.0, "frame.map.cache": 3.5, "ba": 7.0}
COUNTS = {"frames": 10, "track.iters": 40, "track.graph_iters": 30,
          "track.graph_flops": 300_000_000, "prep.graph_frames": 10, "map.steps": 120,
          "syncs": 230, "predict.graph_frames": 8}
# reader -> its value from HOST and COUNTS (10 frames, a 60 ms frame)
READINGS = {"ingest_ms": 4.0, "upload_ms": 1.5, "unspanned_ms": 60.0 - 50.0,
            "track_outside_ms": 5.0, "track_candidates_ms": 1.0, "track_iters": 4.0,
            "track_iter_ms": 2.0, "prep_local_map_ms": 5.0, "prep_sample_ms": 6.0,
            "prep_insert_ms": 2.5, "prep_pool_ms": 4.5, "map_cache_ms": 3.5,
            "map_steps": 12.0, "host_syncs": 23.0, "track_graph_share": 0.75,
            # K1's 2e8 and the profiler's 1e8 operations (frame_mfu: 5 %), and
            # the replays' 3e8, over 0.6 s at 1e10 a second
            "frame_mfu_with_replays": 10.0, "prep_graph_share": 1.0,
            "predict_graph_share": 0.8}
COUNTER_READERS = {"track_iters", "track_iter_ms", "map_steps", "host_syncs",
                   "track_graph_share", "frame_mfu_with_replays", "prep_graph_share",
                   "predict_graph_share"}


def _trace(stage_host_ms, frames=10, window_s=0.6):
    return types.SimpleNamespace(frames=frames, window_s=window_s, stage_host_ms=stage_host_ms,
                                 k1=[{"flops": 2e8}], matmul_flops=1e8,
                                 peak={"f32_flops": 1e10})


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_its_span_or_counter(name, monkeypatch):
    monkeypatch.setattr(obs, "counters", lambda: dict(COUNTS))
    assert _reader(name)(_trace(dict(HOST))) == pytest.approx(READINGS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_none_where_there_is_nothing(name, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(obs, "counters", lambda: {})
    assert read(_trace({}, frames=0, window_s=0.0)) is None
    if name in COUNTER_READERS:
        assert read(_trace(dict(HOST))) is None
        # counters of frames other than the traced ones are not read
        monkeypatch.setattr(obs, "counters", lambda: dict(COUNTS, frames=11))
        assert read(_trace(dict(HOST))) is None


def test_graph_share_reads_none_from_a_program_without_the_graph(monkeypatch):
    # the iterations counted, the replays not: a program that has no graph
    counts = {k: v for k, v in COUNTS.items() if k != "track.graph_iters"}
    monkeypatch.setattr(obs, "counters", lambda: counts)
    assert _reader("track_graph_share")(_trace(dict(HOST))) is None
    monkeypatch.setattr(obs, "counters", lambda: dict(counts, **{"track.graph_iters": 0}))
    assert _reader("track_graph_share")(_trace(dict(HOST))) == 0.0


def test_prep_graph_share_reads_none_from_a_program_without_the_prep_graphs(monkeypatch):
    counts = {k: v for k, v in COUNTS.items() if k != "prep.graph_frames"}
    monkeypatch.setattr(obs, "counters", lambda: counts)
    assert _reader("prep_graph_share")(_trace(dict(HOST))) is None
    monkeypatch.setattr(obs, "counters", lambda: dict(counts, **{"prep.graph_frames": 0}))
    assert _reader("prep_graph_share")(_trace(dict(HOST))) == 0.0


def test_predict_graph_share_reads_none_from_a_program_without_the_predict_graphs(
        monkeypatch):
    counts = {k: v for k, v in COUNTS.items() if k != "predict.graph_frames"}
    monkeypatch.setattr(obs, "counters", lambda: counts)
    assert _reader("predict_graph_share")(_trace(dict(HOST))) is None
    monkeypatch.setattr(obs, "counters", lambda: dict(counts, **{"predict.graph_frames": 0}))
    assert _reader("predict_graph_share")(_trace(dict(HOST))) == 0.0


def test_mfu_with_replays_reads_none_from_a_program_without_the_graph(monkeypatch):
    # no replays counted: a program without the graph, which frame_mfu reads
    counts = {k: v for k, v in COUNTS.items() if k != "track.graph_flops"}
    monkeypatch.setattr(obs, "counters", lambda: counts)
    assert _reader("frame_mfu_with_replays")(_trace(dict(HOST))) is None
    monkeypatch.setattr(obs, "counters", lambda: dict(counts, **{"track.graph_flops": 0}))
    trace = _trace(dict(HOST))
    assert _reader("frame_mfu_with_replays")(trace) == _reader("frame_mfu")(trace) == 5.0


@pytest.mark.gpu
@pytest.mark.parametrize("precompiled", [False, True], ids=["captured_in_frame", "precompiled"])
def test_a_frame_on_the_card_counts_its_syncs(precompiled, monkeypatch):
    """Without ``precompile()`` the traced frame captures the tracker's,
    predict's and bookkeep's and the prep's graphs; with it, they are
    captured before frame 0 and the traced frame only replays them.
    ``track.graph_flops`` holds the iterations' operations and, once, the
    predict and bookkeep stages'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kept = []

    class Kept(streaming.GraphedTrackStages):
        def __init__(self, *a):
            super().__init__(*a)
            kept.append(self)

    monkeypatch.setattr(streaming, "GraphedTrackStages", Kept)
    system, seq = _system(_config(), device="cuda")
    if precompiled:
        system.precompile()
    _frame(system, seq, 0)
    system.block()
    obs.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _frame(system, seq, 1)
        system.block()
    c = obs.counters()
    assert c["frames"] == 1 and c["syncs"] > 0
    assert c["syncs"] == sum(v for k, v in c.items() if k.startswith("syncs."))
    assert torch.cuda.get_sync_debug_mode() == 0
    assert c["track.iters"] == c["track.graph_iters"] == int(system.sync()["track_iters"][1])
    (stages,) = [f.flops() for k in kept for f in k.frames.values()]
    iterations = c["track.graph_flops"] - stages
    assert stages > 0 and iterations > 0 and iterations % c["track.graph_iters"] == 0
    assert c["prep.graph_frames"] == c["predict.graph_frames"] == 1
    if precompiled:  # predict, bookkeep, prep, the step count and K1's step wait for nothing
        assert not any(c.get(f"syncs.frame.{s}")
                       for s in ("predict", "bookkeep", "prep", "iters", "map"))
    obs.reset_counters()
