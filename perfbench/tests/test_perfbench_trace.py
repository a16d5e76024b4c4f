"""The device trace's reading: the idle time of the card is split over
the innermost spans the host was in, piece by piece."""

import pytest

from perfbench import trace as T


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Ev:
    def __init__(self, name, start, end, cuda):
        import torch
        self.name, self.time_range = name, _Range(start, end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_innermost_prefers_the_latest_and_shortest_span():
    host = [(0, 100, "search_many"), (0, 30, "prepare"),
            (30, 60, "execute_batch"), (120, 130, "search_many")]
    assert T._innermost(host) == [
        (0, 30, "prepare"), (30, 60, "execute_batch"),
        (60, 100, "search_many"), (100, 120, "outside spans"),
        (120, 130, "search_many")]


def test_idle_time_is_split_over_the_spans_it_overlaps():
    names = {"search_many", "prepare", "execute_batch"}
    evs = [_Ev("search_many", 0, 100e6, False), _Ev("prepare", 0, 30e6, False),
           _Ev("execute_batch", 30e6, 60e6, False),
           _Ev("kernel_a", 40e6, 50e6, True),
           _Ev("kernel_b", 45e6, 55e6, True)]
    out = T.device_summary(_Prof(evs), names)
    assert out["busy_s"] == pytest.approx(15.0)
    idle = dict(out["idle_gaps"])
    assert idle["prepare"] == pytest.approx(30.0)
    assert idle["execute_batch"] == pytest.approx(15.0)
    assert idle["search_many"] == pytest.approx(40.0)
    assert sum(idle.values()) == pytest.approx(100.0 - 15.0)
    assert dict(out["device_ops"]) == {"kernel_a": pytest.approx(10.0),
                                       "kernel_b": pytest.approx(10.0)}
