"""The window's arithmetic: a rate over all the work and all the time of
a phase, and a tail over every call, stalls included."""
import time

import numpy as np
import pytest

from portbench import window


def test_rate_and_tail_with_stalls():
    stall_every, stall_s, call_s = 10, 0.03, 0.002

    def call(i):
        calls.append(i)
        time.sleep(stall_s if len(calls) % stall_every == 0 else call_s)
        return b"x"

    calls = []
    ph = window.run_phase("encode", call, 3, 0.6, pixels=1000)
    n = ph.calls
    assert n == len(calls) >= 2 * stall_every
    assert calls[:4] == [0, 1, 2, 0]
    span = ph.ends[-1] - ph.starts[0]
    assert window.mpix_s(ph) == pytest.approx(n * 1000 / span / 1e6)
    # every stall is in the span: the rate is below the stall-free one
    assert window.mpix_s(ph) < 1000 / call_s / 1e6
    lat = ph.latencies_ms()
    assert window.percentile_ms(ph, 95) == pytest.approx(
        float(np.percentile(lat, 95)))
    # more than 5% of the calls stall, so the tail is a stall's
    assert window.percentile_ms(ph, 95) >= stall_s * 1e3 * 0.9
    assert np.median(lat) < stall_s * 1e3 / 2


def test_phase_ends_with_its_last_call():
    def call(i):
        time.sleep(0.05)
        return i

    ph = window.run_phase("decode", call, 1, 0.12, pixels=1,
                          keep=lambda i: i == 1)
    assert ph.calls == 3         # started at 0, 0.05, 0.10 s; none after
    assert ph.span_s >= 0.15
    assert ph.results == [None, 0, None]


def test_failed_calls_count():
    def call(i):
        if i == 1:
            raise RuntimeError("planted")
        return b"y"

    ph = window.run_phase("encode", call, 2, 0.02, pixels=10)
    assert ph.failed == sum(r is False for r in ph.results) >= 1
    assert window.mpix_s(ph) == pytest.approx(
        (ph.calls - ph.failed) * 10 / ph.span_s / 1e6)


def test_keep_draw_follows_the_seed():
    from portbench.run import _keep_every
    a = _keep_every(7, 400, 16)
    b = _keep_every(7, 400, 16)
    picks = [i for i in range(1600) if a(i)]
    assert picks == [i for i in range(1600) if b(i)]
    assert 8 <= sum(1 for i in picks if i < 400) <= 32
    assert picks != [i for i in range(1600) if _keep_every(8, 400, 16)(i)]
