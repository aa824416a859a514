"""The window's arithmetic: whole rounds until the deadline, and a fleet
rate over all of the window's work and time, which a stall lowers."""
import pytest

from portbench import harness

BATCH = {"private": 8, "public": 8}


class Clock:
    """A clock that steps advance by their synthetic durations."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _steps(durations, round_len=4):
    clock = Clock()

    def one_step(t):
        clock.now += durations(t)
        return {"publish": (t + 1) % round_len == 0}

    return harness.run_window(one_step, 4, round_len, 10.0, clock)


def test_the_window_runs_whole_rounds_past_the_deadline():
    # plain steps 1 s, publishing steps 5 s: a round is 8 s, so the
    # deadline at 10 s falls in the second round, which completes
    steps, window = _steps(lambda t: 5.0 if (t + 1) % 4 == 0 else 1.0)
    assert [s["t"] for s in steps] == list(range(4, 12))
    assert window == pytest.approx(16.0)
    assert [s["seconds"] for s in steps] == [1, 1, 1, 5, 1, 1, 1, 5]
    assert harness.fleet_rate(len(steps), 3, BATCH, window) == \
        pytest.approx(3 * 16 * 8 / 16.0)


def test_a_stall_lowers_the_rate():
    def base(t):
        return 5.0 if (t + 1) % 4 == 0 else 1.0

    steps, window = _steps(base)
    stalled, window_s = _steps(lambda t: base(t) + (1.5 if t == 5 else 0))
    assert len(stalled) == len(steps)
    assert window_s == pytest.approx(window + 1.5)
    assert harness.fleet_rate(len(stalled), 3, BATCH, window_s) < \
        harness.fleet_rate(len(steps), 3, BATCH, window)
