"""A cell at a size that a CPU test run can hold: the same YAML, traffic
and comparison, with the static sizes, the optimizer's batch, the sensor
and the number of frames cut."""

import time

TINY = {
    "config": {
        "tpu": {"map_capacity": 4096, "map_hash_size": 16384, "local_map_capacity": 4096,
                "local_map_hash_size": 16384, "max_scan_points": 2048,
                "max_source_points": 512, "pool_capacity": 16384},
        "optimizer": {"batch_size": 512, "init_iter_ratio": 5},
        "continual": {"batch_size_new_sample": 100},
    },
    "sensor": {"beams": 16, "columns": 128},
    "traffic": {"warmup_frames": 4, "trace_frames": 0, "samples": 2, "sample_span_frames": 2},
}
FRAMES = 40


def run_tiny(workload: str, seed: int = 2147483659, seconds: float = 0.5):
    """One CPU run of ``workload`` at the tiny size: the harness's result."""
    from harness import cell, spec

    return cell.run(spec.find_cell(workload), seed, seconds, False, "cpu", time.perf_counter(),
                    overrides=TINY, n_frames=FRAMES)
