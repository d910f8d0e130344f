"""The control of the comparison that decides ``correct``: the system run
in the nearest precision below the one its configuration states, which
the comparison has to refuse.

The configurations state float32 with TF32 off (``clid_slam_torch``
turns TF32 off for every product it runs on the card), so the control is
the system with TF32 on: ``tf32``. ``bf16`` is the system's own path of
bfloat16 operands (``mlp_bf16``), a step further down and the control that
differs on the CPU too. The reference stays at full precision either way.

On the card, at the cell's own size (a short window that still reaches
the sampled frames):

    python3 benchmark/tests/control.py tf32 ncd128.walk 2200000021 15

prints one JSON line with the comparison's numbers and their limits.
"""

import contextlib
import json
import os
import sys
import time

T0 = time.perf_counter()


@contextlib.contextmanager
def lower_precision(kind: str):
    """The system, and only the system, in the lower precision ``kind``."""
    if kind == "tf32":
        import torch

        import clid_slam_torch.device as device

        orig = device.set_full_precision

        def tf32():
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            torch.set_float32_matmul_precision("high")

        device.set_full_precision = tf32
        try:
            yield
        finally:
            device.set_full_precision = orig
    elif kind == "bf16":
        from clid_slam_torch.config import Config

        orig = Config.__dict__["from_dict"]

        def from_dict(args):
            cfg = orig.__func__(args)
            cfg.mlp_bf16 = True
            return cfg

        Config.from_dict = staticmethod(from_dict)
        try:
            yield
        finally:
            Config.from_dict = orig
    else:
        raise ValueError(f"unknown control {kind!r}")


def main(argv) -> int:
    kind, workload, seed, seconds = argv[0], argv[1], int(argv[2]), float(argv[3])
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [bench, os.path.dirname(bench)]
    import torch

    from harness import cell, spec

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    with lower_precision(kind):
        res = cell.run(spec.find_cell(workload), seed, seconds, False, torch.device("cuda", 0),
                       T0)
    print(json.dumps({"control": kind, "workload": workload, "seed": seed,
                      "correct": res["correct"], "frames": res["frames"],
                      "checks": {n: {"value": v, "limit": lim} for n, v, lim in res["checks"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
