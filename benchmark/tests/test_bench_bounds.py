"""The kernels' bounds against hand-computed values at the shapes of the
port's kernel table (3.35 TB/s, 67 TFLOP/s)."""

import math

import pytest

from benchmark.bounds import PEAKS, b1, b10, k1, k3


def test_peaks_are_the_h100_data_sheet():
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert PEAKS["f32_ops_per_s"] == 67e12


@pytest.mark.parametrize("module,shape,ms,by", [
    # B1, one 50-member chunk of 250^3 float32: 3.125 GB read, 375 MB of
    # running sums read and written.
    (b1, {"e": 50, "v": 250**3, "bytes_per_value": 4},
     (4 * 50 * 250**3 + 200 + 24 * 250**3) / 3.35e12 * 1e3, "bytes"),
    # K1 at 250^3 x 100: 6.25 GB of series, the field written.
    (k1, {"v": 250**3, "n": 100},
     (4 * 250**3 * 100 + 4 * 250**3 + 400) / 3.35e12 * 1e3, "bytes"),
    # B10 on the 4096-voxel subset of 48^3 x 1000.
    (b10, {"v": 4096, "n": 1000, "k": 3},
     (4 * 4096 * 1000 + 4000 + 4 * 4096) / 3.35e12 * 1e3, "bytes"),
    # K3 at the 250^3 headline, 1080p at intermediate scale 0.75: 250
    # slices x 810 x 1440 samples of 36 operations.
    (k3, {"s": 250, "hi": 810, "wi": 1440, "yv": 250, "xv": 250},
     36 * 250 * 810 * 1440 / 67e12 * 1e3, "operations"),
])
def test_bound_matches_hand_computation(module, shape, ms, by):
    seconds, which = module.least(shape)
    assert which == by
    assert math.isclose(seconds * 1e3, ms, rel_tol=1e-12)


def test_table_values():
    """The rounded bounds of the port's kernel table."""
    assert round(b1.least({"e": 50, "v": 250**3,
                           "bytes_per_value": 4})[0] * 1e3, 3) == 1.045
    assert round(k1.least({"v": 250**3, "n": 100})[0] * 1e3, 3) == 1.884
    assert round(b10.least({"v": 4096, "n": 1000, "k": 3})[0] * 1e3,
                 4) == 0.0049
    assert round(k3.least({"s": 250, "hi": 810, "wi": 1440, "yv": 250,
                           "xv": 250})[0] * 1e3, 3) == 0.157
