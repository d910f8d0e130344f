"""The port's live-view bridge (``pipeline/liveview.py``) against
tests/test_liveview.py: the packet wire format (the same bytes as the JAX
package's encoder), a publisher streaming to a client, and a publisher that
never blocks without one."""

import socket
import time

import numpy as np

from clid_slam_torch.pipeline.liveview import (
    LiveViewPublisher,
    decode_packet,
    encode_packet,
    read_packet,
)
from clid_slam_tpu.pipeline import liveview as jax_liveview


def test_packet_roundtrip_and_wire_format():
    pts = np.random.default_rng(0).random((100, 3)).astype(np.float32)
    pkt = encode_packet("frame", 7, {"scan": pts, "pose": np.eye(4)})
    header, arrays = decode_packet(pkt[8:])
    assert header == {"topic": "frame", "frame": 7}
    np.testing.assert_array_equal(arrays["scan"], pts)
    np.testing.assert_array_equal(arrays["pose"], np.eye(4))
    assert pkt == jax_liveview.encode_packet("frame", 7, {"scan": pts, "pose": np.eye(4)})
    j_header, j_arrays = jax_liveview.decode_packet(pkt[8:])
    assert j_header == header and j_arrays.keys() == arrays.keys()


def test_publisher_streams_to_client():
    pub = LiveViewPublisher(port=0)  # ephemeral port
    try:
        cli = socket.create_connection(("127.0.0.1", pub.port), timeout=5)
        time.sleep(0.2)  # let the accept loop pick the client up
        pub.publish_frame(0, np.eye(4, dtype=np.float32), np.zeros((10, 3), np.float32),
                          traj=np.zeros((1, 3), np.float32))
        pub.publish_neural_points(0, np.ones((5, 3), np.float32))
        got = {}
        cli.settimeout(5)
        for _ in range(2):
            header, arrays = read_packet(cli)
            got[header["topic"]] = arrays
        assert "frame" in got and "neural_points" in got
        assert got["frame"]["scan"].shape == (10, 3)
        assert got["neural_points"]["positions"].shape == (5, 3)
        cli.close()
    finally:
        pub.close()


def test_publisher_never_blocks_without_client():
    pub = LiveViewPublisher(port=0)
    try:
        t0 = time.perf_counter()
        for i in range(50):
            pub.publish_frame(i, np.eye(4, dtype=np.float32), np.zeros((1000, 3), np.float32))
        assert time.perf_counter() - t0 < 1.0  # latest-wins, no backpressure
    finally:
        pub.close()
