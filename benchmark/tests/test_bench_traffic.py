"""The traffic generator: a seed repeats, seeds differ, the walks and the
orbit keep to their mixes, and only one closed-loop client is served."""

import itertools
import math

import pytest

from benchmark import spec, traffic

MIXES = ("pearson-field-walk", "pearson-drag", "ksg-drag", "ksg-orbit")
GRID = (128, 128, 32)


def _mix(name):
    return spec._load_json(spec.HERE / "traffic" / f"{name}.json")


def _take(mix, seed, count=200):
    return list(itertools.islice(traffic.interactions(mix, GRID, seed),
                                 count))


@pytest.mark.parametrize("name", [m for m in MIXES if "orbit" not in m])
def test_seed_repeats_and_seeds_differ(name):
    mix = _mix(name)
    assert _take(mix, 2**31 + 5) == _take(mix, 2**31 + 5)
    assert _take(mix, 2**31 + 5) != _take(mix, 2**31 + 6)
    assert _take(mix, 7, count=8) != traffic.warmup(mix, GRID, 7, 8)


def test_orbit_seeds_visit_the_same_cameras_in_either_order():
    mix = _mix("ksg-orbit")
    turn = mix["steps_per_turn"]
    runs = [_take(mix, 2**31 + s, count=turn) for s in range(8)]
    assert runs[0] == _take(mix, 2**31, count=turn)
    positions = [sorted(tuple(round(v, 9) for v in c["camera"]["position"])
                        for c in r) for r in runs]
    assert all(p == positions[0] for p in positions)
    assert len({tuple(r[1]["camera"]["position"]) for r in runs}) == 2


@pytest.mark.parametrize("name", [m for m in MIXES if "orbit" not in m])
def test_walk_steps_are_new_points_inside_the_grid(name):
    mix = _mix(name)
    points = [a["point"] for a in _take(mix, 99, count=2000)]
    assert len(set(points)) == len(points)
    for p, q in zip(points, points[1:]):
        assert all(0 <= c < s for c, s in zip(q, GRID))
        steps = [abs(a - b) for a, b in zip(p, q)]
        assert max(steps) <= mix["step_max"]


def test_orbit_steps_around_the_centre():
    mix = _mix("ksg-orbit")
    cams = [a["camera"] for a in _take(mix, 3, count=300)]
    step = 2 * math.pi / mix["steps_per_turn"]
    for c in cams:
        assert math.isclose(math.dist(c["position"], (0, 0, 0)),
                            mix["radius"], rel_tol=1e-9)
        assert math.isclose(c["position"][1],
                            mix["radius"] * math.sin(mix["phi"]))
    a0 = math.atan2(cams[0]["position"][0], cams[0]["position"][2])
    a1 = math.atan2(cams[1]["position"][0], cams[1]["position"][2])
    assert math.isclose(abs(math.remainder(a1 - a0, 2 * math.pi)), step,
                        rel_tol=1e-9)
    assert math.isclose(a0, mix["start"], abs_tol=1e-12)


def test_orbit_meets_no_camera_twice_in_four_turns():
    """A window of several turns shifts each turn by part of a step, so a
    camera met once is not met again (nor one of the warm-up's)."""
    mix = _mix("ksg-orbit")
    turn = mix["steps_per_turn"]
    cams = [tuple(round(v, 9) for v in a["camera"]["position"])
            for a in _take(mix, 2**31 + 17, count=4 * turn)]
    warm = [tuple(round(v, 9) for v in a["camera"]["position"])
            for a in traffic.warmup(mix, GRID, 2**31 + 17, mix["warmup"])]
    assert len(set(cams + warm)) == len(cams) + len(warm)


def test_orbit_warmup_spans_a_turn():
    mix = _mix("ksg-orbit")
    cams = traffic.warmup(mix, GRID, 11, 8)
    axes = {(i, c["camera"]["position"][i] > 0) for c in cams
            for i in [max((0, 2), key=lambda i: abs(
                c["camera"]["position"][i]))]}
    assert axes == {(0, True), (0, False), (2, True), (2, False)}


@pytest.mark.parametrize("loop,clients", [("open", 1), ("closed", 4)])
def test_only_one_closed_loop_client_is_served(loop, clients):
    mix = dict(_mix("pearson-drag"), loop=loop, clients=clients)
    with pytest.raises(ValueError, match="closed-loop"):
        traffic.interactions(mix, GRID, 1)


def test_check_sample_is_seeded_and_inside():
    a = traffic.check_sample(2**31 + 1, 3, 24)
    assert a == traffic.check_sample(2**31 + 1, 3, 24)
    assert len(set(a)) == 3 and all(0 <= i < 24 for i in a)


@pytest.mark.parametrize("name", [m for m in MIXES if "orbit" not in m])
def test_every_seed_drags_through_the_same_block_ends(name):
    """The seed orders each block's steps and leaves their lengths alone,
    so the work a window meets does not depend on the seed. (A block
    whose steps all meet visited points takes in the next one, so a few
    block ends are passed apart.)"""
    from benchmark.interactions import reference_point
    block = reference_point.BLOCK
    mix = _mix(name)
    runs = [[a["point"] for a in _take(mix, 2**31 + s, count=40 * block + 1)]
            for s in range(4)]
    ends = list(zip(*(r[::block] for r in runs)))
    shared = sum(len(set(e)) == 1 for e in ends)
    assert shared >= 0.9 * len(ends)
    assert len({tuple(r) for r in runs}) == 4
