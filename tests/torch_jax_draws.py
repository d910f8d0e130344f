"""The JAX package's per-frame random numbers, in the injection format of
the port's drivers (``process_frame(..., draws=...)``), so that the port
can run the JAX tests' own random experiment: the JAX drivers start from
``PRNGKey(seed)`` split for the three decoders and then split their key
twice a frame, for map prep and for mapping (clid_slam_tpu/pipeline/
slam.py:466,523 and streaming.py:450,490). ``jax_fused`` puts the JAX
frame step's tracked frames on the package's Pallas mapping kernel off the
TPU and counts the kernel's builds and calls."""

import contextlib

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


class PallasCount:
    """What the JAX package's fused mapping kernel did under ``jax_fused``:
    ``builds`` counts calls of ``make_pallas_map_loop`` (one a trace of a
    frame step that maps on the kernel), ``calls`` the executions of the
    function it returns (one a tracked frame that ran the kernel)."""

    def __init__(self):
        self.builds = 0
        self.calls = 0

    def _tick(self, _losses):
        self.calls += 1

    def read(self):
        """(builds, calls), after every pending kernel call has run."""
        jax.effects_barrier()
        return self.builds, self.calls


@contextlib.contextmanager
def jax_fused(on=True):
    """JAX's tracked-frame mapping body on its Pallas path on any backend.

    The JAX frame step passes ``use_pallas=cfg.map_pallas and
    jax.default_backend() == "tpu"`` to its fast body (``max_outer=1``;
    clid_slam_tpu/pipeline/streaming.py:240-247), so off the TPU its
    tracked frames run the XLA loop. Inside this context a frame step built
    by ``make_frame_step`` gives that body, and only that body,
    ``use_pallas=cfg.map_pallas``; the mapper then runs the kernel in
    interpret mode off the TPU (clid_slam_tpu/mapping/mapper.py:911-913).
    Build and run the JAX system inside the context: the mapper builds the
    kernel when the frame step is traced.

    The mapper falls back to the XLA loop without a word for a config the
    kernel does not take, so the context also counts (``PallasCount``) the
    kernel's builds and its calls; a call is counted where it runs, by a
    ``jax.debug.callback`` on the kernel's losses. ``on=False`` only counts.
    Nothing of the random key chain changes: both loops split the mapping
    key once and draw the batch from the second half (``build_cache``)."""
    from clid_slam_tpu.mapping import mapper as jmp
    from clid_slam_tpu.ops import pallas_mapping as jpm
    from clid_slam_tpu.pipeline import streaming as jst

    count = PallasCount()
    real_build, real_fn, real_step = jpm.make_pallas_map_loop, jmp.make_mapping_fn, jst.make_frame_step
    map_pallas = []  # cfg.map_pallas of the frame step being built

    def build(**kw):
        count.builds += 1
        run = real_build(**kw)

        def counted(*args):
            out = run(*args)
            jax.debug.callback(count._tick, out[2])
            return out

        return counted

    def frame_step(cfg, *args, **kw):
        map_pallas.append(bool(cfg.map_pallas))
        try:
            return real_step(cfg, *args, **kw)
        finally:
            map_pallas.pop()

    def mapping_fn(**kw):
        if map_pallas and kw.get("max_outer") == 1:
            kw["use_pallas"] = map_pallas[-1]
        return real_fn(**kw)

    jpm.make_pallas_map_loop = build
    if on:
        jmp.make_mapping_fn, jst.make_frame_step = mapping_fn, frame_step
    try:
        yield count
    finally:
        jpm.make_pallas_map_loop = real_build
        jmp.make_mapping_fn, jst.make_frame_step = real_fn, real_step
