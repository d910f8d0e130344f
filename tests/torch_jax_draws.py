"""The JAX package's per-frame random numbers, in the injection format of
the port's drivers (``process_frame(..., draws=...)``), so that the port
can run the JAX tests' own random experiment: the JAX drivers start from
``PRNGKey(seed)`` split for the three decoders and then split their key
twice a frame, for map prep and for mapping (clid_slam_tpu/pipeline/
slam.py:466,523 and streaming.py:450,490)."""

import numpy as np
import jax
import torch


def frame_draws(cfg, key, n_batches=1, sharded=False):
    """``(next_key, draws)`` for one frame from the driver's key before it;
    ``n_batches`` replay batches (frame 0's general body takes
    ceil(iters / map_resample_every)). ``sharded``: the sharded drivers'
    chain (clid_slam_tpu/parallel/slam_sharded.py:311,351,364 and
    pipeline/streaming_sharded.py:281,318,350), which splits the append's
    key from the system's key, not from the prep key."""
    P, S = cfg.max_scan_points, cfg.all_sample_n
    key, k_prep = jax.random.split(key)
    if sharded:
        k_s = k_prep
        key, k_over = jax.random.split(key)
    else:
        k_s, k_over = jax.random.split(k_prep)
    ks, kf, kb = jax.random.split(k_s, 3)
    key, k_map = jax.random.split(key)

    def batch_fn(k_batch):
        def batch(pool):
            k1, k2 = jax.random.split(k_batch)
            return (
                np.asarray(jax.random.randint(k1, (cfg.bs,), 0, max(int(pool.size), 1))),
                np.asarray(jax.random.randint(
                    k2, (cfg.bs_new_sample,), 0, max(int(pool.new_count), 1))),
            )
        return batch

    batches, k = [], k_map
    for _ in range(n_batches):
        k, k_batch = jax.random.split(k)
        batches.append(batch_fn(k_batch))
    return key, dict(
        sample=(np.asarray(jax.random.normal(ks, (cfg.surface_sample_n, P))),
                np.asarray(jax.random.uniform(kf, (cfg.free_front_n, P))),
                np.asarray(jax.random.uniform(kb, (cfg.free_behind_n, P)))),
        append=torch.from_numpy(np.array(jax.random.uniform(k_over, (P * S + 1,)))),
        batches=batches,
    )


def first_frame_batches(cfg) -> int:
    """Replay batches frame 0's general body can take (adaptive offset
    included)."""
    return -(-(cfg.iters * cfg.init_iter_ratio + 10) // max(1, cfg.map_resample_every))


def fixed(draws, pool):
    """``draws`` with its batch functions evaluated on ``pool`` (the JAX
    system's pool after the frame's append: mapping does not change it),
    as plain arrays that pickle to a spawned rank."""
    out = dict(draws, append=draws["append"].numpy())
    out["batches"] = [b(pool) for b in draws["batches"]]
    return out
