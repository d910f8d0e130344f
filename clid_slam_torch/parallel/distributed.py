"""Multi-process runtime of the sharded drivers (port of
clid_slam_tpu/parallel/distributed.py).

JAX runs one process over a mesh of devices; the port runs one rank a
shard in one ``torch.distributed`` process group. ``initialize`` joins (or
skips) that group: explicit arguments win, else the variables ``torchrun``
sets (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) are read. On the card the group is NCCL and each process
pins ``cuda:LOCAL_RANK``; with ``device="cpu"`` it is gloo. With nothing
configured it is a single-process no-op, as JAX's is.

    torchrun --nproc_per_node N my_script.py   # N cards on one machine

where the script calls ``initialize()`` and then drives a sharded system
(``run_sharded_slam``) on every rank with the same frames.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass
class DistributedContext:
    initialized: bool  # this call brought up the process group
    process_index: int
    process_count: int
    local_devices: int  # devices this process drives (1: one rank a card)
    global_devices: int  # shards over every process

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> DistributedContext:
    """Join (or skip) the process group of the sharded drivers.

    ``coordinator_address`` is ``host:port`` or an init-method URL
    (``tcp://...``, ``file://...``); else ``MASTER_ADDR``/``MASTER_PORT``
    give it. ``num_processes`` and ``process_id`` default to ``WORLD_SIZE``
    and ``RANK``. With no address (and no group already up) this is a
    single-process context that initializes nothing."""
    dev = resolve_device(device)
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")

    initialized = False
    if coordinator_address is not None and not dist.is_initialized():
        if num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator address needs num_processes and "
                             "process_id (or WORLD_SIZE and RANK)")
        if dev.type == "cuda":
            local = _env_int("LOCAL_RANK")
            torch.cuda.set_device(process_id % torch.cuda.device_count() if local is None
                                  else local)
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=url,
                                world_size=num_processes, rank=process_id)
        initialized = True

    up = dist.is_initialized()
    return DistributedContext(
        initialized=initialized,
        process_index=dist.get_rank() if up else 0,
        process_count=dist.get_world_size() if up else 1,
        local_devices=1,
        global_devices=dist.get_world_size() if up else 1,
    )


def shutdown():
    """Leave the process group (a no-op when none is up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def run_sharded_slam(cfg, scans, imu_windows, n_devices=None, seed_pose=None, device=None):
    """Every rank builds the same ``ShardedSlamSystem`` over the process
    group and feeds it the same frames; returns (odom_poses [n,4,4],
    system) on every rank. Without a process group it calls
    ``initialize()``; when nothing is configured there either, it brings up
    a group of this one process (an in-process store), as JAX's runs over
    the local devices, and leaves it up so that the system's collectives
    (``neural_point_count``) still work: ``shutdown()`` ends it.
    ``seed_pose`` is (rot, pos, vel or None)."""
    from .slam_sharded import ShardedSlamSystem

    dev = resolve_device(device)
    if not dist.is_initialized() and not initialize(device=dev).initialized:
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    system = ShardedSlamSystem(cfg, n_devices=n_devices, total_frames=len(scans) + 4,
                               device=dev)
    if seed_pose is not None:
        rot, pos, vel = seed_pose
        system.tracker.x.rot = rot.copy()
        system.tracker.x.pos = pos.copy()
        if vel is not None:
            system.tracker.x.vel = vel.copy()
    for i, scan in enumerate(scans):
        system.process_frame(i, scan, imu_windows[i])
    return system.odom_poses[: len(scans)], system
