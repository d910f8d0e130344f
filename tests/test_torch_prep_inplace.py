"""Map prep written in place (``make_prep_fn``'s stages with
``inplace=True``, as ``mapping/prep.py:GraphedPrep`` replays them on the
card) against the functional prep, on the CPU, bit for bit: four tracked
frames of new inputs in each ``filter_pool_now`` variant, every tensor of
the result and the generator's state, the frame id a device scalar and the
random numbers drawn ahead by ``prep.draw``. The local map's crop, the
pool's window filter and its eviction run in these frames. Between frames
the map gets new certainty and stamp tensors, as the mapping step makes."""

from types import SimpleNamespace

import pytest
import torch

from clid_slam_torch.mapping import prep as prp
from clid_slam_torch.pipeline.streaming import clone_state
from torch_prep_frames import after_mapping, frame_inputs, preps, prep_leaves, small_system


@pytest.fixture(scope="module")
def start():
    return small_system("cpu")


@pytest.mark.parametrize("filter_pool_now", [False, True])
def test_inplace_prep_equals_the_functional_prep(start, filter_pool_now):
    system, seq = start
    prep = preps(system.cfg)[filter_pool_now]
    window = system.cfg.diff_travel_dist_local
    fun, inp = clone_state(system.state), clone_state(system.state)
    fun_map, inp_map = fun.map_state, inp.map_state
    fun_local, inp_local, fun_pool, inp_pool = fun.local_map, inp.local_map, fun.pool, inp.pool
    n = system.cfg.max_scan_points
    draws = [torch.empty(s) for s in prep.draw_shapes(n)]
    evicted = 0
    for i in range(1, 5):
        points, mask, pose, travel = frame_inputs(system, seq, i)
        before = [x.clone() for x in prep_leaves(prp.PrepResult(
            fun_map, fun_local, fun_pool, *[torch.zeros(())] * 4))]
        want = prep(fun_map, fun_local, fun_pool, points, mask, pose, travel, i, window,
                    generator=fun.key)
        # the functional prep leaves its input state as it was
        for x, y in zip(before, prep_leaves(prp.PrepResult(
                fun_map, fun_local, fun_pool, *[torch.zeros(())] * 4))):
            assert torch.equal(x, y), i
        prep.draw(inp.key, *draws)
        f = SimpleNamespace(
            map_state=inp_map, local_map=inp_local, pool=inp_pool, points=points, mask=mask,
            pose=pose, travel_dist=travel, frame_id=torch.tensor(i, dtype=torch.int32),
            window=window, generator=None, sample_draws=tuple(draws[:3]),
            append_uniform=draws[3], colors=None, sem_labels=None, inplace=True,
        )
        prep.start(f)
        for _, stage in prep.stages:
            stage(f)
        got = prp._result(f)
        for x, y in zip(got.map_state.tensors(), inp_map.tensors()):
            assert x is y  # written in place
        for x, y in zip(got.local_map.tensors() + got.pool.tensors(),
                        inp_local.tensors() + inp_pool.tensors()):
            assert x is y
        for k, (x, y) in enumerate(zip(prep_leaves(got), prep_leaves(want))):
            assert torch.equal(x, y), (i, k)
        assert torch.equal(inp.key.get_state(), fun.key.get_state()), i
        evicted += int(want.pool.size) == want.pool.data.shape[0]
        fun_map, inp_map = after_mapping(want.map_state, i), after_mapping(got.map_state, i)
        fun_local, inp_local, fun_pool, inp_pool = (want.local_map, got.local_map, want.pool,
                                                    got.pool)
    assert evicted == 4 and int(fun_map.count) > int(system.state.map_state.count)
