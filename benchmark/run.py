"""Run one cell of the benchmark of ``clid_slam_torch`` on the card.

    python3 benchmark/run.py --workload ncd128.walk --seed 7 --seconds 30 --trace 0

Prints one JSON line on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``, and last ``checks``: each number that the comparison with
the plain reference read, beside its limit. The same numbers are the last
lines of standard error. Needs as many CUDA cards as the cell asks for;
exits with 2 and prints no result without them, and with 1 if the run
failed or loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process, one host thread of numerics: worker pools that spin between
# the host's small numpy and torch calls only add jitter to a host-paced loop
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "clid_slam_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ``clid_slam_torch`` is not
    ``clid_slam_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def result_line(cell, res: dict, trace: bool, device_name: str) -> dict:
    """The JSON object the run prints, ``checks`` last."""
    from harness import stats

    metrics = {}
    if not trace:
        values = {
            "frames_per_s": stats.frames_per_s(res["frames"], res["window_s"]),
            "frame_p95_ms": stats.p95_ms(res["latencies"]),
            "device_mem_peak_gib": res["mem_peak"] / 2**30,
            "setup_s": res["setup_s"],
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for name, entry in cell.per_layer.items():
            value = cell.readers[name](res["trace"])
            if value is not None:
                metrics[name] = {"value": value, "unit": entry["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": int(res["mem_peak"])}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if trace:
        t = res["trace"]
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        line["breakdown"] = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in res["checks"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    import torch

    torch.set_num_threads(1)

    from harness import cell as run_cell
    from harness import spec

    cell = spec.find_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    res = run_cell.run(cell, a.seed, a.seconds, bool(a.trace), dev, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 1
    line = result_line(cell, res, bool(a.trace), torch.cuda.get_device_name(dev))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
