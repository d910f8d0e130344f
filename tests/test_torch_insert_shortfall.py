"""A map's live rows re-inserted into an empty map of twice the capacity
and hash size, 32768 rows a call (as ``chip_smoke.py``'s sharded phase
fills a shard from a finished run's map), do not all go in, in either
package, and the shortfall is explained row for row (ROADMAP, "mirrored
as is"):

- rows that share a voxel with another row of the call (a map holds such
  rows where a hash collision orphaned an earlier point of the voxel):
  ``insert_points`` down-samples its candidates to one a voxel;
- voxels that share a bucket of the new table with another voxel of the
  call: the down-sampling keeps one candidate a bucket
  (``voxel_down_sample_mask(..., table_size=hash_size)``);
- over several calls, kept candidates whose voxel an earlier call already
  put in the map: the probe finds that point in their bucket.

Nothing else drops a row (``chip_smoke.py:insert_shortfall`` counts each
cause, and the card's ``sharded`` phase checks the same sum), and the
port's map equals the JAX package's leaf for leaf after the same calls.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import insert_shortfall
from clid_slam_torch.models import neural_map as tnm
from clid_slam_tpu.models import neural_map as jnm

RES = 0.3
CALL = 32768


def _run_map(cap, hsize, frames, n):
    """A map built the way a run builds it: frames of surface points around
    moving centres, inserted into a table small enough to collide."""
    rng = np.random.default_rng(0)
    st = jnm.init_map(cap, hsize, 8)
    travel = jnp.zeros(64)
    for f in range(frames):
        c = rng.uniform(-20, 20, 3)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts = (c + d * rng.uniform(4, 8, (n, 1))).astype(np.float32)
        st, _ = jnm.insert_points(st, jnp.asarray(pts), jnp.ones(n, bool), RES, travel, f, 1e9)
    return np.array(st.positions)[: int(st.count)]


@pytest.mark.parametrize("cap,hsize,frames,n", [(1 << 14, 1 << 15, 6, 4000),
                                                (1 << 15, 1 << 17, 12, 6000),
                                                (1 << 16, 1 << 15, 12, 8000)])
def test_reinsert_shortfall_is_mirrored_and_explained(cap, hsize, frames, n):
    pos = _run_map(cap, hsize, frames, n)
    cap2, hs2 = 2 * cap, 2 * hsize
    j, t = jnm.init_map(cap2, hs2, 8), tnm.init_map(cap2, hs2, 8)
    travel = jnp.zeros(64)
    causes = {}
    for i in range(0, len(pos), CALL):
        p = torch.from_numpy(pos[i : i + CALL].copy())
        for k, v in insert_shortfall(t, p, RES).items():
            causes[k] = causes.get(k, 0) + v
        ones = np.ones(len(p), bool)
        j, _ = jnm.insert_points(j, jnp.asarray(p.numpy()), jnp.asarray(ones), RES, travel,
                                 frames, 1e9)
        t, _ = tnm.insert_points(t, p, torch.from_numpy(ones), RES, torch.zeros(64), frames, 1e9)
    for a, b in zip(j, t.tensors()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    shortfall = len(pos) - int(t.count)
    assert shortfall > 0 and causes["shared_bucket"] > 0
    assert shortfall == sum(causes.values()), causes
    assert causes["in_map_near"] == 0
    if len(pos) > CALL:  # a voxel split across calls goes in once
        assert causes["in_map"] > 0
