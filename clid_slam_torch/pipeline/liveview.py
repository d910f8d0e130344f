"""Live-view bridge (the port's copy of clid_slam_tpu/pipeline/liveview.py):
stream SLAM state over a TCP socket to an off-host viewer.

Capability analog of the reference's Open3D GUI process
(gui/slam_gui.py:39-1465 renders neural points / current scan / mesh /
SDF slices / trajectory; gui/gui_utils.py:12-132 VisPacket transport over
an mp.Queue with latest-wins draining, :166-177). A card host is often headless,
so instead of an in-process window the pipeline PUBLISHES the same packet
content over TCP; `python -m clid_slam_torch.tools.live_viewer` (run on any
workstation with open3d) renders it. The control half of the reference's
GUI loop (pause / mesh cadence — gui_utils.ControlPacket) already exists
as the file-based ControlChannel (pipeline/control.py).

Design constraints mirrored from the reference transport:

- **latest-wins**: a slow/absent viewer must never stall odometry. The
  publisher keeps a 1-deep send slot per topic; unsent packets are
  replaced (gui_utils.get_latest_queue semantics), and all socket IO
  runs on a daemon thread.
- **self-describing packets**: length-prefixed npz blobs with a JSON
  header — no pickle, no viewer-side version coupling.

Wire format per packet:
  8-byte little-endian total length | 4-byte header length | JSON header
  {"topic": ..., "frame": ...} | npz payload bytes.
"""

from __future__ import annotations

import io as _io
import json
import socket
import struct
import threading
from typing import Dict, Optional

import numpy as np


def encode_packet(topic: str, frame: int, arrays: Dict[str, np.ndarray]) -> bytes:
    buf = _io.BytesIO()
    np.savez_compressed(buf, **arrays)
    payload = buf.getvalue()
    header = json.dumps({"topic": topic, "frame": int(frame)}).encode()
    body = struct.pack("<I", len(header)) + header + payload
    return struct.pack("<Q", len(body)) + body


def decode_packet(body: bytes):
    (hlen,) = struct.unpack_from("<I", body, 0)
    header = json.loads(body[4 : 4 + hlen].decode())
    arrays = dict(np.load(_io.BytesIO(body[4 + hlen :])))
    return header, arrays


def read_packet(sock: socket.socket):
    """Blocking read of one packet from a connected socket (viewer side)."""
    raw = b""
    while len(raw) < 8:
        chunk = sock.recv(8 - len(raw))
        if not chunk:
            return None
        raw += chunk
    (n,) = struct.unpack("<Q", raw)
    body = b""
    while len(body) < n:
        chunk = sock.recv(min(1 << 20, n - len(body)))
        if not chunk:
            return None
        body += chunk
    return decode_packet(body)


class LiveViewPublisher:
    """Non-blocking TCP publisher for SLAM visualization packets.

    Accepts at most one viewer connection; all sends happen on a daemon
    thread with latest-wins per-topic slots so the SLAM loop never waits
    on the network."""

    def __init__(self, port: int = 9876, host: str = "0.0.0.0"):
        self._slots: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._closed = False
        self._client: Optional[socket.socket] = None
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ publish
    def publish(self, topic: str, frame: int, **arrays):
        """Queue one packet (latest-wins per topic); never blocks."""
        pkt = encode_packet(
            topic, frame,
            {k: np.asarray(v) for k, v in arrays.items() if v is not None},
        )
        with self._lock:
            self._slots[topic] = pkt
        self._wake.set()

    def publish_frame(
        self, frame: int, pose: np.ndarray, scan_xyz: Optional[np.ndarray],
        traj: Optional[np.ndarray] = None,
    ):
        """The per-frame basics (VisPacket.add_scan + trajectory)."""
        arrays = {"pose": np.asarray(pose, np.float32)}
        if scan_xyz is not None:
            arrays["scan"] = np.asarray(scan_xyz, np.float32)
        if traj is not None:
            arrays["traj"] = np.asarray(traj, np.float32)
        self.publish("frame", frame, **arrays)

    def publish_neural_points(
        self, frame: int, positions: np.ndarray,
        colors: Optional[np.ndarray] = None,
    ):
        """Map points (+ optional PCA feature colors,
        VisPacket.add_neural_points_data)."""
        self.publish("neural_points", frame, positions=positions,
                     colors=colors)

    def publish_mesh(self, frame: int, vertices, triangles, colors=None):
        self.publish("mesh", frame, vertices=vertices, triangles=triangles,
                     colors=colors)

    def publish_sdf_slice(self, frame: int, points, sdf):
        self.publish("sdf_slice", frame, points=points, sdf=sdf)

    # ------------------------------------------------------------ internals
    def _run(self):
        while not self._closed:
            try:
                self._srv.settimeout(0.5)
                try:
                    client, _ = self._srv.accept()
                except socket.timeout:
                    continue
                self._client = client
                while not self._closed:
                    self._wake.wait(timeout=0.5)
                    self._wake.clear()
                    with self._lock:
                        batch = list(self._slots.items())
                        self._slots.clear()
                    for _, pkt in batch:
                        client.sendall(pkt)
            except OSError:
                self._client = None
                continue

    def close(self):
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        if self._client is not None:
            try:
                self._client.close()
            except OSError:
                pass
