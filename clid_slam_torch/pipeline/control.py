"""Minimal runtime control channel (the port's copy of
clid_slam_tpu/pipeline/control.py) — the headless stand-in for the
reference GUI's ControlPacket back-channel (gui/gui_utils.py:180-220:
pause, mesh/SDF toggles, mesh resolution/frequency changes sent from the
viewer process to the SLAM loop).

Training hosts are often headless, so the channel is a JSON file polled once per
frame (cheap: one stat() when idle). Any external tool — a notebook, a
dashboard, a shell — steers the run by writing it:

    echo '{"pause": true}'                > run_dir/control.json
    echo '{"mesh_now": true}'             > run_dir/control.json
    echo '{"mesh_freq_frame": 50, "mesh_res_m": 0.05}' > run_dir/control.json
    echo '{"stop": true}'                 > run_dir/control.json

Supported keys (all optional):
  pause: bool            — spin (poll at 5 Hz) until cleared
  stop: bool             — finish the run cleanly after this frame
  mesh_now: bool         — write a local mesh this frame (one-shot)
  slice_now: bool        — write an SDF slice this frame (one-shot)
  mesh_res_m: float      — override reconstruction resolution
  mesh_freq_frame: int   — override in-loop meshing cadence
  sdfslice_freq_frame: int — override slice cadence
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field


@dataclass
class ControlState:
    pause: bool = False
    stop: bool = False
    mesh_now: bool = False
    slice_now: bool = False
    overrides: dict = field(default_factory=dict)


class ControlChannel:
    ONE_SHOT = ("mesh_now", "slice_now")
    OVERRIDES = ("mesh_res_m", "mesh_freq_frame", "sdfslice_freq_frame")

    def __init__(self, run_path: str, filename: str = "control.json"):
        # no dir creation: an absent file simply means "no commands yet"
        self.path = os.path.join(run_path, filename)
        self._mtime = 0.0
        self.state = ControlState()

    def _read(self):
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return
        if mtime == self._mtime:
            return
        self._mtime = mtime
        try:
            with open(self.path) as f:
                cmd = json.load(f) or {}
        except (OSError, ValueError):
            return
        st = self.state
        st.pause = bool(cmd.get("pause", st.pause))
        st.stop = bool(cmd.get("stop", st.stop))
        for k in self.ONE_SHOT:
            if cmd.get(k):
                setattr(st, k, True)
        for k in self.OVERRIDES:
            if k in cmd:
                st.overrides[k] = cmd[k]

    def poll(self, block_while_paused: bool = True) -> ControlState:
        """Refresh from disk; when paused, spin until unpaused (the
        reference blocks its loop on ControlPacket.flag_pause the same
        way, slam.py main-loop top). One-shot flags are returned set
        exactly once."""
        self._read()
        while block_while_paused and self.state.pause and not self.state.stop:
            time.sleep(0.2)
            self._read()
        out = ControlState(
            pause=self.state.pause,
            stop=self.state.stop,
            mesh_now=self.state.mesh_now,
            slice_now=self.state.slice_now,
            overrides=dict(self.state.overrides),
        )
        self.state.mesh_now = False
        self.state.slice_now = False
        return out
