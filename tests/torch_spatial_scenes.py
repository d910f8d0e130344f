"""The scenes, constants and JAX-side helpers shared by the sharded-map
parity tests (tests/test_torch_spatial*.py): tests/test_spatial.py's
scenes, the pool, the MLP and the JAX key chain's batch draws, and the
position-derived features both packages give a shard's points."""

import numpy as np
import jax
import jax.numpy as jnp

from clid_slam_tpu.mapping import pool as jpl
from clid_slam_tpu.models import decoder as jdec
from clid_slam_tpu.ops.voxel import neighbor_offsets
from torch_sharded_ranks import features_of

RES = 0.3
F = 8
KNN = 6
NB = neighbor_offsets(2, 0.5)
MVD2 = 3.0 * (3 * RES) ** 2
BS = 1024
ITERS = 5
CAP, HASH = 1 << 12, 1 << 14
KW = dict(
    feature_dim=F, knn_k=KNN, nb_offs=NB, resolution=RES, max_valid_dist2=MVD2,
    sdf_scale=0.055, sigma=0.055, bs=BS, bs_new=0, gradient_decimation=8,
    num_grad_eps=RES * 0.2, weight_e=0.5, loss_weight_on=True, lr=0.02,
)
TRACKER_KW = dict(
    knn_k=6, n_cand=16, nb_offs=NB, resolution=RES, max_valid_dist2=MVD2, sdf_scale=0.055,
    min_grad_norm=0.0, max_grad_norm=100.0, min_nn_count=1, max_iteration=20,
    term_thre_deg=0.01, term_thre_m=0.001,
)
BODIES = {"cached": "cached", "sharded_batch": True, "replicated": False}


def scenes():
    """The inputs of every case, from seeds (tests/test_spatial.py's
    scenes)."""
    rng = np.random.default_rng(0)
    insert_pts = rng.uniform(-5, 5, size=(2000, 3)).astype(np.float32)
    centers = rng.uniform(-15, 15, size=(32, 3)).astype(np.float32)
    cluster_pts = (centers[:, None, :] + rng.uniform(-0.25, 0.25, size=(32, 4, 3))
                   ).reshape(-1, 3).astype(np.float32)
    query_pts = (centers + rng.uniform(-0.05, 0.05, size=centers.shape)).astype(np.float32)
    m = 4096
    dirs = rng.normal(size=(m, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    off = rng.uniform(-0.3, 0.3, size=(m, 1)).astype(np.float32)
    coords = ((4.0 + off) * dirs).astype(np.float32)
    label = off[:, 0]
    pool = jpl.init_pool(1 << 13, 1 << 13)
    pool = jpl.append_samples(
        pool, jnp.asarray(coords), jnp.asarray(label), jnp.ones((m,), jnp.float32),
        jnp.ones((m,), bool), 0, jnp.zeros((m,), bool),
    )
    mlp = jdec.init_mlp(jax.random.PRNGKey(1), F + 3, 64, 1)
    # the tracker: a scan of the sphere from inside, a slightly moved pose
    u = rng.standard_normal((512, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    c, s = np.cos(0.01), np.sin(0.01)
    rest0 = np.zeros(12, np.float32)
    rest0[9:12] = [0, 0, -9.81]
    mask = np.ones(512, bool)
    mask[-20:] = False
    tracker_args = ((u * 4.0).astype(np.float32), mask,
                    np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32),
                    np.array([0.02, -0.01, 0.005], np.float32), rest0,
                    (np.eye(18) * 1e-2).astype(np.float32))
    return dict(
        kw=KW, cap=CAP, hash=HASH, iters=ITERS, insert_pts=insert_pts,
        cluster_pts=cluster_pts, query_pts=query_pts, sphere_pts=coords,
        sphere_mask=np.abs(label) < 0.1, pool=[np.asarray(a) for a in pool],
        mlp=[np.asarray(a) for a in jax.tree.leaves(mlp)], tracker_kw=TRACKER_KW,
        tracker_args=tracker_args, draws={name: draws(pool, name) for name in BODIES},
    ), pool, mlp


def draws(pool, body):
    """The batch draws JAX's mapping_fn makes from PRNGKey(2): one batch
    for the cached body, one an iteration for the others."""
    hi = max(int(pool.size), 1)
    key = jax.random.PRNGKey(2)
    out = []
    for _ in range(1 if body == "cached" else ITERS):
        key, kb = jax.random.split(key)
        k1, _ = jax.random.split(kb)
        out.append((np.asarray(jax.random.randint(k1, (BS,), 0, hi)), None))
    return out


def with_position_features(sstate, certainty=False):
    """Each shard's live rows get ``features_of`` their positions (and a
    certainty from it), as the ranks set theirs."""
    feats = np.array(sstate.geo_feats)
    cert = np.array(sstate.certainty)
    pos = np.asarray(sstate.positions)
    for s, cnt in enumerate(np.asarray(sstate.count)):
        feats[s, :cnt] = features_of(pos[s, :cnt], F)
        cert[s, :cnt] = np.abs(features_of(pos[s, :cnt], 1)[:, 0])
    out = sstate._replace(geo_feats=jnp.asarray(feats))
    return out._replace(certainty=jnp.asarray(cert)) if certainty else out


