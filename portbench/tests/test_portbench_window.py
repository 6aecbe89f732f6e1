"""The window's arithmetic on synthetic timings: a rate is all the work
over the whole window, a percentile is over every request."""

import numpy as np
import pytest

from portbench.bench import window


class Clock:
    def __init__(self, durations):
        self.t = 100.0
        self.durations = list(durations)

    def __call__(self):
        return self.t

    def request(self, i):
        self.t += self.durations[i]
        return i


def test_closed_loop_counts_every_request_to_the_last_end():
    durs = [0.3, 0.5, 0.2, 0.4, 0.9, 0.1]
    clock = Clock(durs)
    seen = []
    opened, closed, recs = window.closed_loop(
        clock.request, 1.5, sink=lambda i, o: seen.append((i, o)),
        clock=clock)
    # requests start while < 1.5 s have passed: 0.0, 0.3, 0.8, 1.0, 1.4
    assert len(recs) == 5 and seen == [(i, i) for i in range(5)]
    assert closed - opened == pytest.approx(sum(durs[:5]))
    rate = window.end_to_end("points_per_s", opened, closed, recs, 1000, 0)
    assert rate == pytest.approx(5000 / sum(durs[:5]))


def test_latency_percentiles_are_over_all_requests():
    rng = np.random.default_rng(0)
    durs = list(rng.uniform(0.2, 0.6, 120))
    clock = Clock(durs)
    opened, closed, recs = window.closed_loop(clock.request,
                                              sum(durs) - 1e-9, clock=clock)
    assert len(recs) == 120
    ms = np.array(durs) * 1e3
    for q in (50, 90):
        got = window.end_to_end(f"latency_ms_p{q}", opened, closed, recs, 1,
                                0)
        assert got == pytest.approx(np.percentile(ms, q))
    assert window.end_to_end("setup_s", opened, closed, recs, 1, 12.5) \
        == 12.5


def test_keep_going_overrules_the_clock():
    clock = Clock([0.1] * 10)
    calls = []

    def keep(go):
        calls.append(go)
        return len(calls) <= 3
    _, _, recs = window.closed_loop(clock.request, 100.0, keep_going=keep,
                                    clock=clock)
    assert len(recs) == 3

