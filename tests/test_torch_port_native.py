"""PyTorch port (``correrender_tpu_torch``) vs the JAX package: the CPU
baseline (``correrender_tpu_torch/cpu_baseline.cpp``, built by
``native.cpu_baseline`` with ``g++ -fopenmp`` at first use).

The baseline's KSG is an implementation independent of both packages'
estimators (a 2-D k-d tree's (k + 1) nearest neighbours, then binary
searches in the sorted marginals), so it holds the port's plain KSG, the
plain version of B9 and B10, to a second implementation of KSG. All
cases share one seeded numpy draw: 1000 members, 24 voxels, the first 8
correlated with the reference. Bars: the KSG within 5e-5 of JAX's and of
the port's estimator (``tests/test_pallas.py:357``), Pearson within 2e-5
(``tests/test_pallas.py:26``); the copy equal to the bit to the JAX
package's own library on the same inputs.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu import native as jax_native
from correrender_tpu.ops.mi_ksg import mutual_information_kraskov as jksg
from correrender_tpu.ops.pearson import pearson as jpearson

from correrender_tpu_torch import native
from correrender_tpu_torch.ops.cuda.ksg_kernel import mi_ksg_plain
from correrender_tpu_torch.ops.mi_ksg import mutual_information_kraskov
from correrender_tpu_torch.ops.pearson import pearson

ATOL_KSG = 5e-5  # tests/test_pallas.py:357
ATOL_PEARSON = 2e-5  # tests/test_pallas.py:26
MEMBERS, VOXELS = 1000, 24


@pytest.fixture(scope="module")
def draw():
    """``(ref (n,), fields (n, V))``, member-major as the baseline reads
    them."""
    rng = np.random.default_rng(0)
    ref = rng.normal(size=MEMBERS).astype(np.float32)
    fields = rng.normal(size=(MEMBERS, VOXELS)).astype(np.float32)
    fields[:, :8] = ref[:, None] * 0.9 + 0.3 * fields[:, :8]
    return ref, fields


def members(draw, n):
    ref, fields = draw
    return ref[:n], np.ascontiguousarray(fields[:n])


@pytest.mark.parametrize("estimator", [1, 2])
@pytest.mark.parametrize("n", [150, 1000])
def test_ksg_field_cpu_matches_jax_and_the_port(draw, n, estimator):
    ref, fields = members(draw, n)
    cpu = native.ksg_field_cpu(ref, fields, k=3, estimator=estimator)
    want_jax = np.asarray(jksg(jnp.asarray(ref), jnp.asarray(fields.T), k=3,
                               estimator=estimator, use_noise=False))
    series, tref = torch.from_numpy(fields.T.copy()), torch.from_numpy(ref)
    want_port = mutual_information_kraskov(tref, series, k=3,
                                           estimator=estimator,
                                           use_noise=False).numpy()
    plain = mi_ksg_plain(series, tref, k=3, estimator=estimator,
                         use_noise=False).numpy()
    assert cpu.shape == (VOXELS,) and cpu.dtype == np.float32
    assert cpu[:8].min() > 0.5  # the correlated third carries information
    np.testing.assert_allclose(cpu, want_jax, rtol=0, atol=ATOL_KSG)
    np.testing.assert_allclose(cpu, want_port, rtol=0, atol=ATOL_KSG)
    np.testing.assert_allclose(cpu, plain, rtol=0, atol=ATOL_KSG)


@pytest.mark.parametrize("n", [150, 1000])
def test_pearson_field_cpu_matches_jax_and_the_port(draw, n):
    ref, fields = members(draw, n)
    cpu = native.pearson_field_cpu(ref, fields)
    want_jax = np.asarray(jpearson(jnp.asarray(ref), jnp.asarray(fields.T)))
    want_port = pearson(torch.from_numpy(ref),
                        torch.from_numpy(fields.T.copy())).numpy()
    np.testing.assert_allclose(cpu, want_jax, rtol=0, atol=ATOL_PEARSON)
    np.testing.assert_allclose(cpu, want_port, rtol=0, atol=ATOL_PEARSON)


@pytest.mark.parametrize("entry", ["pearson", "ksg1", "ksg2"])
def test_the_copy_equals_the_jax_packages_library(draw, entry):
    ref, fields = members(draw, 150)
    if entry == "pearson":
        got = native.pearson_field_cpu(ref, fields)
        dll = jax_native.cpu_baseline()
        want = np.empty(VOXELS, np.float32)
        fp = jax_native.ctypes.POINTER(jax_native.ctypes.c_float)
        dll.pearson_field_cpu(ref.ctypes.data_as(fp),
                              fields.ctypes.data_as(fp), VOXELS, 150,
                              want.ctypes.data_as(fp))
    else:
        est = int(entry[-1])
        got = native.ksg_field_cpu(ref, fields, 3, est)
        want = jax_native.ksg_field_cpu(ref, fields, 3, est)
    np.testing.assert_array_equal(got, want)


def test_field_entries_check_the_reference_length(draw):
    ref, fields = members(draw, 150)
    with pytest.raises(ValueError, match="members"):
        native.ksg_field_cpu(ref[:149], fields)


@pytest.mark.parametrize("call", [
    lambda d: d.pearson_throughput_cpu(4096, 50),
    lambda d: d.pearson_throughput_cpu_t(4096, 50, 1),
    lambda d: d.pearson_throughput_cpu_t(4096, 50, 0),
    lambda d: d.ksg_throughput_cpu(16, 100, 3, 1),
    lambda d: d.ksg_throughput_cpu(16, 100, 3, 2),
    lambda d: d.ddr_bandwidth_gbs(1 << 18, 2),
], ids=["pearson", "pearson_1t", "pearson_all_t", "ksg1", "ksg2", "ddr"])
def test_throughput_entries_are_positive_and_finite(call):
    value = call(native.cpu_baseline())
    assert isinstance(value, float) and math.isfinite(value) and value > 0


def test_cpu_core_count_is_at_least_one():
    assert native.cpu_baseline().cpu_core_count() >= 1


@pytest.mark.parametrize("threads", [1, 0])
def test_threaded_calls_leave_torchs_threads_alone(draw, threads):
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(2)
        dll = native.cpu_baseline()
        dll.pearson_throughput_cpu_t(2048, 20, threads)
        native.ksg_field_cpu(*members(draw, 150))
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(before)


def test_extra_flags_build_into_another_file(tmp_path):
    source = native._BASELINE_SOURCE
    plain = native.build_library(source, tmp_path, "the CPU baseline")
    omp = native.build_library(source, tmp_path, "the CPU baseline",
                               extra_flags=("-fopenmp",))
    assert plain != omp and plain.exists() and omp.exists()
    assert plain == native.library_path(source, tmp_path)
    assert omp == native.library_path(source, tmp_path, ("-fopenmp",))
    # The shipped loader's library is the OpenMP build under build/.
    native.cpu_baseline()
    assert native.library_path(
        source, native.BUILD_ROOT / "cpu_baseline", ("-fopenmp",)).exists()
