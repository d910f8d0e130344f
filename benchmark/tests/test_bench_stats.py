"""The end-to-end arithmetic: the rate and the tail are taken over every
frame of the window."""

import pytest

from harness import stats


def test_rate_counts_every_frame_over_the_whole_window():
    assert stats.frames_per_s(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.frames_per_s(1, 0.0)


@pytest.mark.parametrize("stall_s", [0.1, 2.0])
def test_p95_is_the_tail_of_every_frame(stall_s):
    lat = [0.050] * 99 + [stall_s]
    # one stalled frame in a hundred sits above the 95th percentile and
    # leaves it where the other frames put it
    assert stats.p95_ms(lat) == pytest.approx(50.0)
    # six in a hundred move it: a tail is not a median of chunks
    lat6 = [0.050] * 94 + [stall_s] * 6
    assert stats.p95_ms(lat6) == pytest.approx(stall_s * 1e3)


def test_a_stalled_frame_costs_the_rate_its_whole_time():
    window = 99 * 0.05 + 2.0
    assert stats.frames_per_s(100, window) == pytest.approx(100 / 6.95)
