"""The traced span's reduction, on made-up profiler events: it runs from
the marker's end to the last device activity, on a full pipeline."""
import pytest
from torch.autograd import DeviceType

from bench import tracing


class Event:
    def __init__(self, name, start, end, device=DeviceType.CUDA):
        self._name, self._start, self._end = name, start, end
        self._device = device

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start


def test_the_span_starts_at_the_markers_end():
    ms = 1_000_000
    events = [
        Event("lead", 0, 10 * ms),              # the lead-in block, untraced
        Event("copy", 9 * ms, 11 * ms),         # its log copy, clipped
        Event(tracing.MARK + "(long)", 10 * ms, 10 * ms + 1000),
        Event("a", 12 * ms, 20 * ms),           # the gap before it counts
        Event("b", 15 * ms, 22 * ms),           # overlaps a: counted once
        Event("a", 25 * ms, 30 * ms),
        Event("c", 30 * ms + ms // 2, 31 * ms),
        Event("cudaGraphLaunch", 19 * ms, 26 * ms, DeviceType.CPU),
    ]
    span, busy, kernels, gaps, short = tracing.reduce_events(events)
    lo = 10 * ms + 1000
    assert span == pytest.approx((31 * ms - lo) / 1e9)
    assert busy == pytest.approx((11 * ms - lo + 15.5 * ms) / 1e9)
    assert kernels == {"a": (2, pytest.approx(0.013)),
                       "b": (1, pytest.approx(0.007)),
                       "c": (1, pytest.approx(0.0005))}
    assert [g for g, _ in gaps] == ["host: cudaGraphLaunch",
                                    "host: no host activity traced",
                                    "host: no host activity traced"]
    assert [s for _, s in gaps] == [pytest.approx(0.003),
                                    pytest.approx(0.001),
                                    pytest.approx(0.0005)]
    assert short == pytest.approx(0.0005)


@pytest.mark.parametrize("marks", [0, 2])
def test_a_trace_without_one_marker_is_refused(marks):
    events = [Event("a", 0, 5)] + [Event(tracing.MARK, 6 + k, 7 + k)
                                   for k in range(marks)]
    with pytest.raises(RuntimeError, match="marker"):
        tracing.reduce_events(events)
