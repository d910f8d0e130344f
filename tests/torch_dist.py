"""Rank harness of the sharded parity tests (not collected as a test).

``run_ranks(case, size, inputs, tmp_path)`` (or ``Ranks(...).join()``) spawns ``size`` processes
(``torch.multiprocessing``, start method ``spawn``) that join one gloo
process group through a ``FileStore`` under ``tmp_path`` (no TCP port, so
parallel test workers cannot clash), run ``case(mesh, inputs)`` and hand
back its result, one per rank, as pickled numpy (with ``group=False`` the
ranks start without a group and the case brings one up itself, its mesh a
``Mesh(None, rank, size)``). ``case`` is named as
"module:function" and must live in a module that imports neither JAX nor
clid_slam_tpu (``torch_sharded_ranks``), so a child never starts XLA.

A rank that raises ends at once and the others are killed; a rank that
hangs in a mismatched collective hits the process group's ``timeout``; and
the parent joins against a deadline. So a broken case fails its test
within ``deadline_s``, never the whole suite's time limit. Each rank runs
torch on one thread.
"""

import datetime
import importlib
import os
import pickle
import sys
import time
import traceback

COLLECTIVE_TIMEOUT_S = 60
DEADLINE_S = 240


def _rank_main(case, rank, size, tmp, timeout_s, group=True):
    err_path = os.path.join(tmp, f"rank{rank}.err")
    try:
        import torch
        import torch.distributed as dist

        from clid_slam_torch.parallel.collectives import Mesh, make_group_mesh

        torch.set_num_threads(1)
        if group:
            store = dist.FileStore(os.path.join(tmp, "store"), size)
            dist.init_process_group("gloo", store=store, rank=rank, world_size=size,
                                    timeout=datetime.timedelta(seconds=timeout_s))
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        mod, fn = case.split(":")
        mesh = make_group_mesh(size) if group else Mesh(None, rank, size)
        out = getattr(importlib.import_module(mod), fn)(mesh, inputs)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:
        with open(err_path, "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.write(traceback.format_exc())
        os._exit(1)


class Ranks:
    """Spawned ranks of one case; ``join()`` waits for them."""

    def __init__(self, case, size, inputs, tmp_path, deadline_s=DEADLINE_S,
                 timeout_s=COLLECTIVE_TIMEOUT_S, group=True):
        import torch.multiprocessing as mp

        self.case, self.size, self.tmp = case, size, str(tmp_path)
        os.makedirs(self.tmp, exist_ok=True)
        for name in os.listdir(self.tmp):
            if name == "store" or name.startswith("rank"):
                os.remove(os.path.join(self.tmp, name))
        with open(os.path.join(self.tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        ctx = mp.get_context("spawn")
        self.procs = [
            ctx.Process(target=_rank_main, args=(case, r, size, self.tmp, timeout_s, group),
                        daemon=True)
            for r in range(size)
        ]
        for p in self.procs:
            p.start()
        self.end = time.monotonic() + deadline_s
        self.deadline_s = deadline_s

    def kill(self):
        for p in self.procs:
            if p.exitcode is None:
                p.kill()
        for p in self.procs:
            p.join(5)

    def join(self):
        """The per-rank results in rank order. Raises with the failing
        rank's traceback when a rank fails, and at the deadline when the
        ranks have not all ended; kills every rank left either way."""
        procs, tmp = self.procs, self.tmp
        try:
            while True:
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError(f"rank {bad[0]} of {self.size} failed in {self.case}:\n"
                                       + _err(tmp, bad[0]))
                if all(p.exitcode == 0 for p in procs):
                    break
                if time.monotonic() > self.end:
                    raise TimeoutError(
                        f"{self.case} on {self.size} ranks did not end in {self.deadline_s} s")
                time.sleep(0.02)
        finally:
            self.kill()
        out = []
        for r in range(self.size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def run_ranks(case, size, inputs, tmp_path, **kw):
    """``case`` ("module:function") on ``size`` gloo ranks; returns the
    per-rank results in rank order (``Ranks`` starts them without waiting,
    so the caller can compute the JAX side meanwhile)."""
    return Ranks(case, size, inputs, tmp_path, **kw).join()


def _err(tmp, rank):
    path = os.path.join(tmp, f"rank{rank}.err")
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return "(no traceback: the process was killed)"
