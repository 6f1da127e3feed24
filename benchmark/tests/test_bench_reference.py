"""The plain references against the port's plain paths at small sizes
on the CPU: the same sums (Pearson in float64 within rounding), the
same KSG counts, and the same shear-warp frame."""

import math

import numpy as np
import pytest
import torch

from benchmark import data as bench_data
from benchmark.reference import dvr as ref_dvr
from benchmark.reference import mi_kraskov
from benchmark.reference.mi_kraskov import ksg_mi, threefry_uniform
from benchmark.reference.pearson import pearson_fields
from correrender_tpu_torch.core.fields import GridMetadata
from correrender_tpu_torch.ops.mi_ksg import mutual_information_kraskov
from correrender_tpu_torch.ops.noise import tie_break_noise
from correrender_tpu_torch.ops.pearson import pearson
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp
from correrender_tpu_torch.render.tf import TransferFunction
from correrender_tpu_torch.utils.fixtures import synth_box_lambda_field

DS = {"xs": 20, "ys": 16, "zs": 8, "members": 60, "linear": True}


def _blocks(chunk):
    return list(bench_data.planted_box(DS, chunk, 2**31 + 77, "cpu"))


def test_box_strength_is_the_generators():
    lam = bench_data.box_strength(40, 36, 16, "cpu")
    want = synth_box_lambda_field(40, 36, 16)
    assert torch.allclose(lam.double(), torch.as_tensor(want), atol=1e-6)


@pytest.mark.parametrize("chunk", [60, 12])
def test_pearson_fields_match_the_float64_pearson(chunk):
    blocks = _blocks(chunk)
    stack = torch.cat(blocks).reshape(DS["members"], -1)
    points = [(3, 4, 5), (19, 0, 7)]
    got = pearson_fields(blocks, points)
    for r, (x, y, z) in enumerate(points):
        ref = torch.cat([b[:, z, y, x] for b in blocks]).double()
        want = pearson(ref, stack.T.double(), dtype=torch.float64)
        assert torch.allclose(got[r], want.double(), atol=1e-6)
    sub = torch.tensor([0, 5, 77, 300])
    assert torch.allclose(pearson_fields(blocks, points, voxels=sub),
                          got[:, sub])


def test_threefry_noise_is_the_ports():
    for n in (1, 100, 1000):
        nx, ny = tie_break_noise(n, "cpu")
        assert np.array_equal(threefry_uniform(617406168, n), nx.numpy())
        assert np.array_equal(threefry_uniform(864730169, n), ny.numpy())


@pytest.mark.parametrize("estimator", [1, 2])
def test_ksg_matches_the_ports_plain_estimator(estimator):
    (block,) = _blocks(60)
    series = block.reshape(60, -1).T.contiguous()
    ref = block[:, 2, 3, 4].contiguous()
    got = ksg_mi(series, ref, k=3, estimator=estimator)
    want = mutual_information_kraskov(ref, series, k=3, estimator=estimator)
    assert float((got - want.double()).abs().max()) <= 2e-6
    whole = mi_kraskov.field([block], [(4, 3, 2)], {
        "k": 3, "kraskov_estimator": estimator})
    assert torch.equal(whole[0], got)
    sub = torch.tensor([0, 9, 700])
    assert torch.equal(mi_kraskov.field([block], [(4, 3, 2)], {
        "k": 3, "kraskov_estimator": estimator}, voxels=sub)[0], got[sub])
    chunked = mi_kraskov.field(_blocks(12), [(4, 3, 2)], {
        "k": 3, "kraskov_estimator": estimator})
    assert torch.equal(chunked[0], got)


def _pairwise_counts(v, radius):
    lo = v[..., :, None] - radius[..., :, None]
    hi = v[..., :, None] + radius[..., :, None]
    vj = v[..., None, :]
    return ((vj >= lo) & (vj < hi)).sum(-1)


@pytest.mark.parametrize("ties", [False, True])
def test_sorted_counts_are_the_pairwise_counts(ties):
    """The binary-search count of [v − r, v + r) is the comparisons'
    count, ties, zero and negative radii included."""
    gen = torch.Generator().manual_seed(5)
    v = torch.randn((4, 300), generator=gen)
    if ties:
        v = torch.round(v * 4) / 4
    radius = torch.rand((4, 300), generator=gen) * 0.3 - 0.05
    radius[:, ::17] = 0.0
    radius[:, 1::19] = 0.25
    want = _pairwise_counts(v, radius)
    got = mi_kraskov._counts(torch.sort(v, dim=-1).values, v, radius)
    assert torch.equal(got, want)
    got_1d = mi_kraskov._counts(torch.sort(v[0]).values, v[0], radius)
    assert torch.equal(got_1d, _pairwise_counts(v[0].expand(4, 300),
                                                radius))


CAMERAS = [
    {"position": (0.05, 0.3, 0.85)},        # z principal, reversed slices
    {"position": (0.1, -0.2, -0.9)},        # z principal, in order
    {"position": (0.81, 0.25, 0.1)},        # x principal
    {"position": (-0.7, 0.25, -0.4)},       # x principal, reversed
]


@pytest.mark.parametrize("cam", CAMERAS)
def test_frame_matches_the_ports_plain_shearwarp(cam):
    cam = {"look_at": (0.0, 0.0, 0.0), "up": (0.0, 1.0, 0.0),
           "fovy": math.pi / 4, "z_near": 0.001, "z_far": 100.0, **cam}
    (block,) = _blocks(60)
    field = pearson_fields([block], [(5, 6, 3)])[0].reshape(8, 16, 20)
    field = field.float()
    tf = TransferFunction.from_colormap(
        "coolwarm", domain=(-1.0, 1.0),
        opacity_points=((0.0, 0.8), (0.5, 0.0), (1.0, 0.8)))
    lut = torch.as_tensor(ref_dvr.lut_from_points(
        "coolwarm", ((0.0, 0.8), (0.5, 0.0), (1.0, 0.8))))
    assert torch.equal(lut, tf.lut)
    box = GridMetadata(xs=20, ys=16, zs=8).render_box()
    mine = ref_dvr.render_box((8, 16, 20))
    assert all(np.array_equal(a, b) for a, b in zip(box, mine))
    camera = Camera(position=cam["position"], look_at_point=cam["look_at"],
                    up=cam["up"], fovy=cam["fovy"])
    want = dvr_shearwarp(field, camera, tf, image_size=(72, 40), box=box,
                         background=(0, 0, 0, 0))
    got = ref_dvr.dvr_frame(field, cam, lut, (-1.0, 1.0),
                            image_size=(72, 40))
    serve = {"image_size": [72, 40], "renderer_settings": {
        "attenuation": 100.0}}
    assert torch.equal(ref_dvr.frame(field, cam, lut, (-1.0, 1.0), serve),
                       got)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6
    assert float(want[..., 3].max()) > 0.05  # the volume is in view


def test_frame_reference_refuses_settings_it_does_not_draw():
    serve = {"image_size": [8, 8], "renderer_settings": {"quality": "exact"}}
    with pytest.raises(ValueError, match="quality"):
        ref_dvr.frame(torch.zeros((2, 2, 2)), {}, None, (0, 1), serve)
