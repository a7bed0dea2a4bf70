"""The windows' whole-window arithmetic, on a fake clock."""

import pytest

from gpubench import window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def run_calls(durations, seconds=1.0):
    clock = Clock()

    def call(i):
        clock.t += durations[i % len(durations)]
    return window.calls_window(call, seconds, lambda: None, clock)


def test_every_call_counts_and_the_last_is_finished():
    win = run_calls([0.3])
    assert win["calls"] == 4 and win["seconds"] == pytest.approx(1.2)


def test_a_stall_in_the_window_lowers_the_rate():
    steady = run_calls([0.1])
    stalled = run_calls([0.1, 0.1, 0.5, 0.1])
    rate = lambda w: w["calls"] / w["seconds"]
    assert rate(stalled) < rate(steady)
    assert rate(steady) == pytest.approx(10.0)


def test_device_time_after_the_last_call_is_in_the_window():
    clock = Clock()
    pending = []

    def call(i):
        clock.t += 0.1          # the host enqueues
        pending.append(0.2)     # the device will run this long

    def sync():
        clock.t += sum(pending)
        pending.clear()
    win = window.calls_window(call, 1.0, sync, clock)
    assert win["seconds"] == pytest.approx(win["calls"] * 0.3)


def test_closed_loop_p95_is_over_every_batch():
    clock = Clock()
    lat = [0.05] * 19 + [0.5]

    def call(i):
        clock.t += lat[i % len(lat)]
    win = window.closed_loop(call, 0.96, lambda: None, clock)
    assert win["batches"] == 20
    assert window.percentile(win["latency_s"], 95) == pytest.approx(0.05)
    assert window.percentile(win["latency_s"], 100) == pytest.approx(0.5)
    assert win["seconds"] == pytest.approx(sum(lat))


def test_percentile_nearest_rank():
    assert window.percentile(list(range(1, 101)), 95) == 95
    assert window.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_laps_time_each_phase():
    clock = Clock()
    laps = window.Laps(lambda: None, clock)
    clock.t = 2.0
    laps("a")
    clock.t = 2.5
    laps("b")
    assert laps.seconds == {"a": 2.0, "b": 0.5}
