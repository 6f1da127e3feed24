"""The timed window: closed loop, or dispatched ahead by a cell's
``ahead_s``."""

import itertools

import torch

from benchmark import drivers
from benchmark.run import Window


class _Stamp(drivers._HostStamp):
    """A host stamp that counts the waits on it."""

    waits = 0

    def synchronize(self):
        _Stamp.waits += 1


class _Driver:
    point = (1, 2, 3)

    def interact(self, action):
        return {"field": torch.zeros(2)}


def _window(ahead_s, syncs):
    w = Window(_Driver(), itertools.repeat({"point": (1, 2, 3)}), {0, 5},
               torch.device("cpu"), ahead_s)
    w.stamps = lambda: [_Stamp(), _Stamp()]
    w.sync = lambda: syncs.append(1)
    return w


def test_a_closed_loop_waits_for_every_interaction():
    syncs, _Stamp.waits = [], 0
    w = _window(0.0, syncs)
    w.timed(0.0, count=40)
    assert w.completed == len(w.latency_ms) == 40
    assert len(syncs) == 41 and _Stamp.waits == 0
    assert len(w.kept) == 2


def test_ahead_keeps_interactions_in_flight_and_waits_for_all_at_the_end():
    syncs, _Stamp.waits = [], 0
    w = _window(1e6, syncs)
    w.timed(0.0, count=40)
    # Only the first is waited for alone; the rest are in flight until the
    # window's one wait at its end.
    assert _Stamp.waits == 1 and len(syncs) == 1
    assert w.completed == len(w.latency_ms) == 40
    assert len(w.kept) == 2


def test_ahead_holds_at_most_ahead_s_of_the_cards_work():
    syncs, _Stamp.waits = [], 0
    w = _window(1e-9, syncs)
    w.timed(0.0, count=40)
    assert _Stamp.waits == 39 and len(syncs) == 1
    assert w.completed == len(w.latency_ms) == 40


def test_only_the_field_cell_is_dispatched_ahead():
    from benchmark import spec
    ahead = {name: spec.load_cell(name).settings.get("ahead_s", 0)
             for name in ("synthbox250-m1000-pearson-field",
                          "linear4x4-pearson-drag", "linear4x4-ksg-drag",
                          "linear4x4-ksg-orbit")}
    assert ahead.pop("synthbox250-m1000-pearson-field") == 4
    assert set(ahead.values()) == {0}
