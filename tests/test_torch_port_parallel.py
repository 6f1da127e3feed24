"""PyTorch port (correrender_tpu_torch.parallel, io.writers, config 5) vs
the JAX package's sharded functions on its 8-device virtual CPU mesh
(``tests/conftest.py``).

The port's ranks run as gloo processes at world sizes 2 and 4 on
``(space, members)`` meshes (2, 1), (1, 2), (2, 2), (4, 1) and (1, 4):
one spawn a world size runs every check (``tests/torch_parallel_ranks.py``)
and saves what each rank computed; each rank is joined with a timeout of
its own. The tests below hold those results to the JAX function on the
same mesh shape and inputs, each bar stated beside its assert.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from correrender_tpu.calculators.noise import gaussian_blur_3d as jax_blur
from correrender_tpu.io.base import load_volume as jax_load_volume
from correrender_tpu.parallel import halo as jax_halo
from correrender_tpu.parallel.dvr_sharded import (
    dvr_shearwarp_sharded as jax_dvr_sharded,
)
from correrender_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
    reshard_member_to_space as jax_reshard,
    shard_member_stack as jax_shard,
)
from correrender_tpu.parallel.pearson_sharded import (
    correlate_member_sharded as jax_member_sharded,
    correlate_space_sharded as jax_space_sharded,
    pearson_member_sharded as jax_pearson_sharded,
)
from correrender_tpu.render import Camera as JaxCamera
from correrender_tpu.render import TransferFunction as JaxTF
from correrender_tpu.utils import metrics as jmetrics

import torch_parallel_ranks as ranks
from correrender_tpu_torch.app.baseline_configs import config5_stack
from correrender_tpu_torch.io import load_volume
from correrender_tpu_torch.parallel.mesh import block_range
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp
from correrender_tpu_torch.render.tf import TransferFunction

#: Seconds a world size's ranks may take before each is killed. A rank
#: takes about 50 s alone on the CPU, 40 of them config 5's eight
#: 1280×720 warps (one thread a rank); the margin covers a loaded host.
RANK_TIMEOUT_S = 300
SHAPES = [shape for world in (2, 4) for shape in ranks.MESHES[world]]
IDS = [f"{s}x{m}" for s, m in SHAPES]
DATA = ranks.inputs()


def spawn(world: int, tmp) -> list:
    """Run ``ranks.run`` on ``world`` gloo ranks; each rank's results."""
    ctx = torch.multiprocessing.start_processes(
        ranks.run, args=(world, str(tmp)), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for proc in ctx.processes:
            proc.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [p for p in ctx.processes if p.is_alive()]
        for proc in hung:
            proc.kill()
            proc.join()
    assert not hung, f"{len(hung)} of {world} ranks hung past " \
                     f"{RANK_TIMEOUT_S} s"
    codes = [p.exitcode for p in ctx.processes]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=False))
            for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"world{world}")
        out[world] = (spawn(world, tmp), tmp)
    return out


def results(worlds, shape):
    world = shape[0] * shape[1]
    return worlds[world][0]


def key(shape, name):
    return f"{shape[0]}x{shape[1]}/{name}"


def jax_mesh(shape):
    return jax_make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])


# -- mesh layout and reshards ----------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_blocks_and_reshards_round_trip(worlds, shape):
    for rank in results(worlds, shape):
        assert rank[key(shape, "stack_equal")]
        assert rank[key(shape, "space_block_equal")]
        assert rank[key(shape, "round_trip_equal")]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_reshard_refuses_what_jax_refuses(worlds, shape):
    # A one-plane block a rank: Z = space planes, divisible by
    # space × members only when members == 1.
    got = str(results(worlds, shape)[0][key(shape, "reshard_error")])
    space, members = shape
    stack = jnp.asarray(DATA["stack"][:space])
    mesh = jax_mesh(shape)
    if members == 1:
        assert got == ""
        jax_reshard(jax_shard(stack, mesh), mesh)
        return
    with pytest.raises(ValueError) as want:
        jax_reshard(stack, mesh)
    assert got == str(want.value)


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_refuses_like_jax(worlds, world):
    rank0 = worlds[world][0][0]
    for space, members, device_type in ranks.mesh_error_cases(world):
        got = str(rank0[f"mesh_error/{space}x{members}/{device_type}"])
        if device_type == "cuda":  # no switch puts a card's mesh on gloo
            assert got == ("a cuda mesh needs the nccl backend, the "
                           "process group runs gloo")
        elif space * members == 1:  # a mesh spans every rank
            assert got.startswith(f"mesh 1x1 leaves ranks of the {world}")
        else:  # the JAX package's message for the same request
            with pytest.raises(ValueError) as want:
                jax_make_mesh(space, members, devices=jax.devices()[:world])
            assert got == str(want.value)


# -- correlation -------------------------------------------------------------

def jax_member_field(shape, measure="pearson", **kw):
    mesh = jax_mesh(shape)
    stack = jax_shard(jnp.asarray(DATA["stack"]), mesh)
    ref = jnp.asarray(DATA["ref"])
    if measure == "pearson" and not kw:
        return np.asarray(jax_pearson_sharded(stack, ref, mesh))
    return np.asarray(jax_member_sharded(stack, ref, mesh, measure, **kw))


#: Port against JAX per measure on the same 240 voxels × 16 members:
#: Pearson's float32 sums in two orders (a few ulps of r), the rank
#: measures' exact counts (tau and rho assembled in float32 alike), binned
#: MI's histograms over global bounds (float32 p log p over 8² bins) and
#: KSG's counts (the same noise, ψ within 1e-6).
BARS = {"pearson": 2e-6, "pearson_absolute": 2e-6, "pearson_bins": 2e-6,
        "spearman": 1e-6, "kendall": 1e-6, "mi_binned": 1e-5,
        "mi_binned_flat": 1e-5, "mi_binned_pairs": 1e-5, "mi_kraskov": 1e-5}


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_pearson_member_sharded_matches_jax(worlds, shape):
    got = results(worlds, shape)[0][key(shape, "pearson")]
    want = jax_member_field(shape)
    assert got.shape == want.shape == DATA["stack"].shape[:3]
    np.testing.assert_allclose(got, want, rtol=0, atol=BARS["pearson"])


@pytest.mark.parametrize("label,measure,kw", ranks.MEMBER_MEASURES,
                         ids=[m[0] for m in ranks.MEMBER_MEASURES])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_correlate_member_sharded_matches_jax(worlds, shape, label, measure,
                                              kw):
    got = results(worlds, shape)[0][key(shape, label)]
    want = jax_member_field(shape, measure, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=BARS[label])


@pytest.mark.parametrize("measure", ranks.SPACE_MEASURES)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_correlate_space_sharded_matches_jax(worlds, shape, measure):
    got = results(worlds, shape)[0][key(shape, "space_" + measure)]
    mesh = jax_mesh(shape)
    stack, mesh = jax_reshard(jax_shard(jnp.asarray(DATA["stack"]), mesh),
                              mesh)
    kw = {"num_bins": 8} if measure == "mi_binned" else {}
    want = np.asarray(jax_space_sharded(stack, jnp.asarray(DATA["ref"]),
                                        mesh, measure, **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=BARS[measure])


# -- halo exchange and the sharded blur --------------------------------------

def jax_padded_blocks(shape, halo):
    """JAX's exchange_halo_z of each space block, as numpy blocks."""
    mesh = jax_mesh(shape)
    fn = jax.shard_map(lambda b: jax_halo.exchange_halo_z(b, halo),
                       mesh=mesh, in_specs=P("space", None, None),
                       out_specs=P("space", None, None), check_vma=False)
    out = np.asarray(fn(jnp.asarray(DATA["vol8"])))
    return np.split(out, shape[0])


@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_exchange_halo_z_matches_jax(worlds, shape, halo):
    space, members = shape
    want = jax_padded_blocks(shape, halo)
    for r, rank in enumerate(results(worlds, shape)):
        s = r // members  # the rank's space index
        got = rank[key(shape, f"halo{halo}_r{r}")]
        # Copies of planes: equal to the bit.
        np.testing.assert_array_equal(got, want[s])
        z0, z1 = block_range(8, space, s)
        clamp = np.clip(np.arange(z0 - halo, z1 + halo), 0, 7)
        np.testing.assert_array_equal(got, DATA["vol8"][clamp])


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_halo_wider_than_a_block_raises_like_jax(worlds, shape):
    space = shape[0]
    halo = 8 // space + 1
    for rank in results(worlds, shape):
        assert str(rank[key(shape, "halo_error")]).startswith(
            f"halo {halo} exceeds the per-shard Z extent {8 // space}")
    with pytest.raises(ValueError, match=f"halo {halo} exceeds the "
                                         f"per-shard Z extent {8 // space}"):
        jax_padded_blocks(shape, halo)


@pytest.mark.parametrize("shape,sigma", [
    pytest.param(shape, sigma, id=f"{i}-{sigma}")
    for shape, i in zip(SHAPES, IDS) for sigma in ranks.blur_sigmas(shape[0])])
def test_gaussian_blur_sharded_matches_jax(worlds, shape, sigma):
    rank0 = results(worlds, shape)[0]
    got = rank0[key(shape, f"blur{sigma}")]
    want = np.asarray(jax_blur(jnp.asarray(DATA["vol8"]), sigma))
    # Against JAX's dense blur, at the dense blur's bar
    # (test_torch_port_calculators.py): float32 sums of 2r + 1 taps an
    # axis, XLA's convolution against shifted products.
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # The halo planes make each block's sums those of the port's dense
    # blur: the same operations in the same order.
    np.testing.assert_array_equal(got, rank0[key(shape, f"blur{sigma}_dense")])


# -- the sharded shear-warp --------------------------------------------------

def frames_of(worlds, shape, name):
    world = shape[0] * shape[1]
    frames = [rank[key(shape, f"dvr_{name}_r{r}")]
              for r, rank in enumerate(results(worlds, shape))]
    for frame in frames[1:]:  # the same frame on every rank
        np.testing.assert_array_equal(frame, frames[0])
    assert len(frames) == world
    return frames[0]


def port_tf():
    return TransferFunction.from_colormap(
        "coolwarm", domain=(0.0, 1.0), opacity_points=((0.0, 0.0),
                                                       (1.0, 0.9)))


@pytest.mark.parametrize("camera", sorted(ranks.CAMERAS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dvr_shearwarp_sharded_matches_the_dense_frame(worlds, shape,
                                                       camera):
    # Against the port's dense dvr_shearwarp of the whole volume: the
    # same K2 classification and K3 sums a slice; the ranks' OVER
    # combine adds one rounding a pixel (1e-6). The eye-inside camera
    # gathers the volume and is the dense call itself.
    got = frames_of(worlds, shape, camera)
    want = dvr_shearwarp(torch.from_numpy(DATA["vol"]),
                         Camera(position=ranks.CAMERAS[camera]), port_tf(),
                         image_size=ranks.IMAGE,
                         background=(0, 0, 0, 0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("camera", sorted(ranks.CAMERAS))
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[0] > 1],
                         ids=[i for s, i in zip(SHAPES, IDS) if s[0] > 1])
def test_dvr_shearwarp_sharded_matches_jax(worlds, shape, camera):
    got = frames_of(worlds, shape, camera)
    tf = JaxTF.from_colormap("coolwarm", domain=(0.0, 1.0),
                             opacity_points=((0.0, 0.0), (1.0, 0.9)))
    want = np.asarray(jax_dvr_sharded(
        jnp.asarray(DATA["vol"]), JaxCamera(position=ranks.CAMERAS[camera]),
        tf, jax_mesh(shape), image_size=ranks.IMAGE,
        background=(0, 0, 0, 0)))
    # The frame bars of the port's dense DVR against JAX
    # (test_torch_port_shearwarp.py): K2's bf16 layout against JAX's B3
    # classification on its CPU path, then the same composite and warp.
    assert np.abs(got - want).max() <= 1e-2
    assert jmetrics.ssim(got, want) >= 0.995


# -- export and config 5 -----------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_netcdf_export_reads_back_in_both_packages(worlds, shape):
    rank0, tmp = worlds[shape[0] * shape[1]]
    field = rank0[0][key(shape, "pearson")]
    path = str(tmp / f"field_{shape[0]}x{shape[1]}.nc")
    got = load_volume(path, device="cpu").get_field("pearson").numpy()
    want = np.asarray(jax_load_volume(path).get_field("pearson"))
    np.testing.assert_array_equal(got, field)
    np.testing.assert_array_equal(want, field)


def config5_inputs():
    xs, ys, zs = ranks.CONFIG5_GRID
    stack = config5_stack(ranks.CONFIG5_GRID, 8, (0, zs), "cpu").numpy()
    ref = np.random.default_rng(3).normal(size=8).astype(np.float32)
    return stack, ref


@pytest.mark.parametrize("world", [2, 4])
def test_config5_matches_jax(worlds, world):
    rank_results, tmp = worlds[world]
    rank0 = rank_results[0]
    # JAX's return keys (baseline_configs.py:258-270), beside the port's
    # blocks and frames.
    assert {"config", "grid", "members", "devices", "sharded_pearson_ms",
            "batch_renders", "batch_render_total_ms", "export_bytes",
            "note"} <= set(str(rank0["config5/keys"]).split())
    stack, ref = config5_inputs()
    mesh = jax_make_mesh(world, 1, devices=jax.devices()[:world])
    want = np.asarray(jax_pearson_sharded(
        jax_shard(jnp.asarray(stack), mesh), jnp.asarray(ref), mesh))
    field = rank0["config5/field"]
    np.testing.assert_allclose(field, want, rtol=0, atol=BARS["pearson"])
    # The export holds the field, read back by the port's loader.
    path = str(rank0["config5/export_path"])
    assert os.path.getsize(path) == int(rank0["config5/export_bytes"])
    np.testing.assert_array_equal(
        load_volume(path, device="cpu").get_field("pearson").numpy(), field)
    # Each batch frame: equal on every rank, and JAX's sharded frame of
    # the same field within the frame bars above.
    tf = JaxTF.from_colormap("coolwarm", domain=(-1, 1))
    for i in range(4):
        frames = [r[f"config5/frame{i}_r{n}"]
                  for n, r in enumerate(rank_results)]
        for frame in frames[1:]:
            np.testing.assert_array_equal(frame, frames[0])
        if world == 2:
            jframe = np.asarray(jax_dvr_sharded(
                jnp.asarray(field), JaxCamera(position=(0.05 + 0.1 * i, 0.2,
                                                        0.9)),
                tf, mesh, image_size=(1280, 720), intermediate_scale=0.5))
            assert np.abs(frames[0] - jframe).max() <= 1e-2
            assert jmetrics.ssim(frames[0], jframe) >= 0.995
