"""The port's copy of the MR auto-policy against the original.

The scripted `pick` / `record` sequences of tests/test_engine.py (probe and
lock, reprobe back-off, probe-window-only rates and discard_first, the cheap
drift reprobe, drain edges, switch hysteresis, drift and per-slot rates) are
driven through `jacobiforcing_tpu.engine.mr_policy.MRAutoPolicy` and through
the copy in lockstep: every pick, every lock state and every snapshot must be
equal, exactly.
"""

import pytest

from jacobiforcing_tpu.engine import mr_policy as jpol
from jacobiforcing_tpu_torch.engine import mr_policy as tpol


class Pair:
    """Both policies behind one interface; each step checks that they agree."""

    def __init__(self, **kw):
        self.j = jpol.MRAutoPolicy(**kw)
        self.t = tpol.MRAutoPolicy(**kw)
        self.steps = 0

    def check(self):
        assert self.t.locked == self.j.locked
        assert self.t._interval == self.j._interval
        assert self.t._since_lock == self.j._since_lock
        assert self.t.snapshot() == self.j.snapshot()

    def pick(self):
        a, b = self.j.pick(), self.t.pick()
        assert a == b
        self.check()
        return a

    def record(self, arm, tokens, wall_s, **kw):
        self.j.record(arm, tokens, wall_s, **kw)
        self.t.record(arm, tokens, wall_s, **kw)
        self.steps += 1
        self.check()

    @property
    def locked(self):
        return self.j.locked

    def drive_until_locked(self, rates, limit=40):
        n = 0
        while self.locked is None and n < limit:
            arm = self.pick()
            self.record(arm, int(rates[arm]), 1.0)
            n += 1
        return n


def _probe_lock_reprobe():
    p = Pair(probe_chunks=2, reprobe_every=10)
    p.drive_until_locked({0: 100.0, 1: 200.0, 2: 150.0})
    assert p.locked == 1
    for _ in range(10):
        assert p.pick() == 1
        p.record(1, 200, 1.0)
    p.pick()  # opens a new probe: the workload flipped
    p.drive_until_locked({0: 100.0, 1: 50.0, 2: 400.0})
    assert p.locked == 2 and p.t.snapshot()["locked"] == "mr_ra_only"
    return p


def _reprobe_backoff():
    p = Pair(probe_chunks=1, reprobe_every=10, backoff_cap=4)
    rates = {0: 100.0, 1: 300.0, 2: 200.0}
    p.drive_until_locked(rates)
    assert p.locked == 1 and p.t._interval == 10
    for want in (20, 40, 40, 40):
        for _ in range(p.t._interval):
            if p.locked is None:
                break
            p.pick()
            p.record(1, 300, 1.0)
        p.pick()
        p.drive_until_locked(rates)
        assert p.t._interval == want
    for _ in range(p.t._interval):  # the locked arm collapses: drift unlock
        if p.locked is None:
            break
        p.pick()
        p.record(1, 30, 1.0)
    assert p.locked is None and p.t._interval == 10
    p.drive_until_locked({0: 100.0, 1: 30.0, 2: 500.0})
    assert p.locked == 2
    return p


def _window_only():
    p = Pair(probe_chunks=1, reprobe_every=10)
    for rate in (1000.0, 100.0, 100.0):
        p.record(p.pick(), int(rate), 1.0)
    assert p.locked == 0
    for _ in range(10):  # a long fast history on the locked arm
        p.record(0, 1000, 1.0)
    p.pick()
    p.drive_until_locked({0: 150.0, 1: 400.0, 2: 100.0})
    assert p.locked == 1, "stale history outweighed the probe window"
    return p


def _discard_first():
    p = Pair(probe_chunks=1, reprobe_every=10, n_arms=4, discard_first=True)
    walls = {0: 1.0, 1: 1.0, 2: 1.0, 3: 20.0}  # arm 3's first call pays set-up
    rates = {0: 100.0, 1: 150.0, 2: 100.0, 3: 600.0}
    for _ in range(20):
        if p.locked is not None:
            break
        arm = p.pick()
        w, walls[arm] = walls[arm], 1.0
        p.record(arm, int(rates[arm]), w)
    assert p.locked == 3 and p.t.snapshot()["locked"] == "single"
    return p


def _drift_reprobe_is_cheap():
    p = Pair(probe_chunks=4, reprobe_every=100)
    assert p.drive_until_locked([100.0, 300.0, 200.0]) == 12 and p.locked == 1
    for _ in range(20):
        if p.locked is None:
            break
        p.record(p.pick(), 30, 1.0)
    assert p.locked is None
    assert p.drive_until_locked([100.0, 30.0, 200.0]) == 3 and p.locked == 2
    return p


def _drain_edges():
    p = Pair(probe_chunks=1, reprobe_every=1000)
    for r in (300.0, 100.0, 100.0):
        p.record(p.pick(), int(r), 1.0)
    for _ in range(10):
        p.record(0, 10, 1.0, drained=True)
    assert p.locked == 0
    for _ in range(10):
        if p.locked is None:
            break
        p.record(0, 10, 1.0)
    assert p.locked is None
    return p


def _switch_hysteresis():
    p = Pair(probe_chunks=1, reprobe_every=10)
    for r in (300.0, 100.0, 100.0):
        p.record(p.pick(), int(r), 1.0)
    for _ in range(10):
        p.record(0, 300, 1.0)
    p.pick()
    p.drive_until_locked({0: 300.0, 1: 315.0, 2: 100.0})
    assert p.locked == 0  # 315 < 1.1 * 300
    for _ in range(p.t._interval):
        if p.locked is None:
            break
        p.record(p.pick(), 300, 1.0)
    p.pick()
    p.drive_until_locked({0: 300.0, 1: 400.0, 2: 100.0})
    assert p.locked == 1
    return p


def _per_slot_rates():
    p = Pair(probe_chunks=1, reprobe_every=1000)
    p.record(0, 160, 1.0, slots=16)  # 10 tokens per slot-second
    p.record(1, 300, 1.0, slots=1)
    p.record(2, 20, 1.0, slots=1)
    assert p.locked == 1
    return p


@pytest.mark.parametrize("script", [
    _probe_lock_reprobe, _reprobe_backoff, _window_only, _discard_first,
    _drift_reprobe_is_cheap, _drain_edges, _switch_hysteresis, _per_slot_rates,
], ids=lambda f: f.__name__.strip("_"))
def test_copy_follows_the_original(script):
    p = script()
    assert p.steps > 0
    assert (p.t.calls, p.t.seen, p.t.n, p.t.prior) == (p.j.calls, p.j.seen, p.j.n, p.j.prior)


def test_copy_has_the_same_arms():
    assert tpol.ARMS == jpol.ARMS and tpol.ARM_SINGLE == jpol.ARM_SINGLE
