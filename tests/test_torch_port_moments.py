"""PyTorch port (correrender_tpu_torch) vs the JAX package: kernel B1's
module (the one-pass chunk moments), ``pearson_from_moments`` and the
member-streamed Pearson field.

On the CPU the B1 wrapper runs its plain version; chip_smoke.py holds the
kernel to it on the card. The JAX kernel runs in Pallas interpret mode,
as tests/test_pallas.py runs it, and the streaming loop is written here
as the JAX repo's ``bench.py`` writes it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu.ops.pallas.moments_kernel import (
    chunk_moments as jax_chunk_moments,
)

from correrender_tpu_torch.calculators.correlation import (
    correlate_field,
    pearson_streamed,
)
from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.moments_kernel import (
    chunk_moments,
    chunk_moments_flat,
    chunk_moments_plain,
)
from correrender_tpu_torch.ops.pearson import pearson_from_moments
from correrender_tpu_torch.utils import fixtures as tfixtures

# tests/test_pallas.py:442-451: Σy and Σy² within 2e-6, Σxy within 2e-5
# (the kernel's f32 sums taken in another order).
TOL_Y = 2e-6
TOL_XY = 2e-5
# The streamed field against bench.py's formulation on JAX's kernel: the
# same formula on sums that differ by their summation order.
ATOL_STREAMED = 2e-6
# The streamed field against K1's field of the whole stack (member-last,
# one warp per voxel): the same formula on sums taken in another order.
ATOL_STREAMED_K1 = 1e-5
TILE_V = 128  # JAX's voxel tile in interpret mode (tests/test_pallas.py)


def _chunk(e, spatial, dtype, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(e,) + spatial).astype(np.float32)
    ref = rng.normal(size=(e,)).astype(np.float32)
    if dtype == "bfloat16":  # the bf16 values both packages read
        c = np.array(jnp.asarray(c).astype(jnp.bfloat16).astype(jnp.float32))
    return c, ref


def _port(c, dtype):
    t = torch.from_numpy(c)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,spatial", [(13, (5, 7, 9)), (50, (3, 5, 7))])
def test_chunk_moments_match_jax_kernel(dtype, e, spatial):
    # E not a multiple of 8 (13) and odd voxel counts (315, 105).
    c, ref = _chunk(e, spatial, dtype)
    want = jax_chunk_moments(jnp.asarray(c).astype(dtype), jnp.asarray(ref),
                             tile_v=TILE_V, interpret=True)
    _build.reset_launch_counts()
    got = chunk_moments(_port(c, dtype), torch.from_numpy(ref))
    assert _build.LAUNCHES["chunk_moments"] == 0  # CPU: the plain version
    plain = chunk_moments_plain(_port(c, dtype).reshape(e, -1),
                                torch.from_numpy(ref))
    for i, (g, w) in enumerate(zip(got, want)):
        tol = TOL_XY if i == 2 else TOL_Y
        assert g.shape == spatial and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)
        assert torch.equal(g.reshape(-1), plain[i])


def test_accumulate_form_equals_the_separate_form():
    c, ref = _chunk(13, (4, 5, 7), "float32")
    flat, r = torch.from_numpy(c).reshape(13, -1), torch.from_numpy(ref)
    acc = torch.from_numpy(
        np.random.default_rng(1).normal(size=(3, flat.shape[1])).astype(
            np.float32))
    want = acc + chunk_moments_flat(flat, r)
    got = chunk_moments_flat(flat, r, acc=acc)
    assert got is acc  # in place
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_padded_rows_change_nothing(dtype):
    c, ref = _chunk(13, (3, 4, 5), dtype)
    pad = np.concatenate([c, np.zeros((3,) + c.shape[1:], np.float32)])
    ref_pad = np.concatenate([ref, np.zeros(3, np.float32)])
    got = chunk_moments_flat(_port(pad, dtype).reshape(16, -1),
                             torch.from_numpy(ref_pad))
    want = chunk_moments_flat(_port(c, dtype).reshape(13, -1),
                              torch.from_numpy(ref))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("flat,ref,acc,exc", [
    (torch.zeros((4, 8), dtype=torch.float64), torch.zeros(4), None,
     TypeError),
    (torch.zeros(8), torch.zeros(8), None, TypeError),
    (torch.zeros((4, 8)), torch.zeros(5), None, ValueError),
    (torch.zeros((4, 8)), torch.zeros(4), torch.zeros((3, 7)), ValueError),
    (torch.zeros((4, 8), device="meta"), torch.zeros(4, device="meta"), None,
     ValueError),
])
def test_chunk_moments_reject_bad_input(flat, ref, acc, exc):
    with pytest.raises(exc):
        chunk_moments_flat(flat, ref, acc=acc)


def _stack(members=60):
    """A planted-box ensemble, member-major ``(n, Z, Y, X)``."""
    return tfixtures.synth_box_ensemble(xs=9, ys=7, zs=4, members=members)


def _bench_field(data, ref, chunk):
    """bench.py's stream (accumulate_onepass over the chunks, then
    assemble), written with JAX's chunk_moments."""
    acc = [jnp.zeros(data.shape[1:], jnp.float32) for _ in range(3)]
    for s in range(0, data.shape[0], chunk):
        m = jax_chunk_moments(jnp.asarray(data[s:s + chunk]),
                              jnp.asarray(ref[s:s + chunk]), tile_v=TILE_V,
                              interpret=True)
        acc = [a + mi for a, mi in zip(acc, m)]
    s_y, s_yy, s_xy = acc
    n = jnp.float32(data.shape[0])
    ref = jnp.asarray(ref)
    s_x = jnp.sum(ref)
    s_xx = jnp.sum(ref * ref)
    num = n * s_xy - s_x * s_y
    den = jnp.sqrt((n * s_xx - s_x * s_x) * (n * s_yy - s_y * s_y))
    return np.asarray(num / den)


@pytest.mark.parametrize("chunk", [20, 13])
def test_pearson_streamed_matches_bench_formulation(chunk):
    data = _stack()
    ref = data[:, 2, 3, 4].copy()
    want = _bench_field(data, ref, chunk)
    t = torch.from_numpy(data)
    got = pearson_streamed((t[s:s + chunk] for s in range(0, 60, chunk)),
                           torch.from_numpy(ref))
    assert got.shape == data.shape[1:]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_STREAMED, rtol=0)
    # pearson_from_moments on the whole stack's moments: the same field.
    m = chunk_moments_flat(t.reshape(60, -1), torch.from_numpy(ref))
    whole = pearson_from_moments(m[0], m[1], m[2], torch.from_numpy(ref))
    np.testing.assert_allclose(whole.reshape(data.shape[1:]).numpy(), want,
                               atol=ATOL_STREAMED, rtol=0)


def test_pearson_streamed_matches_correlate_field():
    data = _stack(100)
    stack = torch.from_numpy(np.ascontiguousarray(np.moveaxis(data, 0, -1)))
    ref = stack[1, 2, 3].clone()
    want = correlate_field(stack, ref)
    t = torch.from_numpy(data)
    got = pearson_streamed([t[s:s + 25] for s in range(0, 100, 25)], ref)
    assert float((got - want).abs().max()) <= ATOL_STREAMED_K1
    # bf16 chunks: the same field up to bf16's rounding of the members.
    got16 = pearson_streamed(
        [t[s:s + 25].to(torch.bfloat16) for s in range(0, 100, 25)], ref)
    assert float((got16 - want).abs().max()) < 2e-2


def test_pearson_streamed_refuses_a_short_stream():
    t = torch.from_numpy(_stack(40))
    with pytest.raises(ValueError, match="40 members"):
        pearson_streamed([t], torch.zeros(50))
    with pytest.raises(ValueError, match="does not match"):
        pearson_streamed([t[:20], t[20:, :2]], torch.zeros(40))
