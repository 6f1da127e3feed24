"""Rank programs of ``tests/test_torch_port_parallel.py``.

The test spawns one process a rank (gloo on the CPU, a ``file://`` store
under the test's directory); each rank runs every check of its world
size on the same inputs and saves what it computed, and the test holds
that to the JAX package. This module imports neither JAX nor the JAX
package, so a rank starts quickly.
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

#: (space, members) meshes per world size.
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (4, 1), (1, 4))}

#: The gathered measures of ``correlate_member_sharded``: (label,
#: measure, keyword arguments).
MEMBER_MEASURES = (
    ("spearman", "spearman", {}),
    ("kendall", "kendall", {}),
    ("mi_binned", "mi_binned", {"num_bins": 8}),
    ("mi_binned_flat", "mi_binned", {"num_bins": 8,
                                     "mi_bounds": (-3.0, 3.5)}),
    ("mi_binned_pairs", "mi_binned", {"num_bins": 8,
                                      "mi_bounds": ((-2.5, 2.5),
                                                    (-3.0, 3.5))}),
    ("mi_kraskov", "mi_kraskov", {"k": 3}),
    ("pearson_absolute", "pearson", {"absolute": True}),
    ("pearson_bins", "pearson", {"num_bins": 8}),
)
SPACE_MEASURES = ("pearson", "spearman", "mi_binned")

#: Cameras of the sharded frames: Z-principal, X-principal (resharded),
#: Y-principal from below, and an eye inside the box (gathered).
CAMERAS = {"z": (0.05, 0.2, 0.9), "x": (0.9, 0.1, 0.15),
           "y": (0.1, -0.8, 0.2), "inside": (0.02, 0.01, 0.03)}
IMAGE = (48, 32)
CONFIG5_GRID = (12, 10, 8)  # (X, Y, Z)

#: Cases of the sharded isosurface (tests/test_dvr_sharded.py's): name →
#: (volume, camera position, axial supersample). "iso" is (9, 10, 11):
#: uneven blocks of every axis on 2 and 4 ranks (a Z-principal camera
#: pads Z, an X-principal one the resharded X); "iso_even" is (8, 8, 12).
ISO_CASES = {
    "z": ("iso", (0.05, 0.1, 0.9), 1),
    "z_back": ("iso", (0.1, -0.05, -0.9), 1),
    "z_even": ("iso_even", (0.05, 0.1, 0.9), 1),
    "x_even": ("iso_even", (0.9, 0.1, 0.05), 1),
    "x_uneven": ("iso", (0.9, 0.1, 0.05), 1),
    "y_back": ("iso", (0.1, -0.9, 0.15), 1),
    "ss2_z": ("iso", (0.05, 0.1, 0.9), 2),
    "ss2_z_back": ("iso", (0.1, -0.05, -0.9), 2),
    "ss3_x": ("iso", (0.9, 0.1, 0.05), 3),
    "inside": ("iso", (0.02, 0.01, 0.03), 1),
}
ISO_IMAGE = (48, 36)
#: The stress runs' sizes ((Z, Y, X), members): Z divisible by 4 ranks.
STRESS_GRID, STRESS_MEMBERS = (8, 6, 5), 16
STRESS_MEASURES = {"spearman": {}, "kendall": {}, "mi_kraskov": {"k": 3}}
SIGMAS = (0.5, 1.0)  # halos of 2 and 3 planes


def blur_sigmas(space: int):
    """The blurs whose halo fits the 8-plane volume's blocks on ``space``
    ranks (a wider one raises, as in JAX)."""
    return [s for s in SIGMAS if (2 if s == 0.5 else 3) <= 8 // space]


def inputs(seed: int = 0) -> dict:
    """The shared inputs: a member stack and its reference series, and
    volumes for the renders (9 planes: uneven blocks on 2 and 4 ranks)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.linspace(-1, 1, n) for n in (8, 6, 5)),
                          indexing="ij")
    base = np.sin(3 * x) * np.cos(2 * y) + z
    stack = (base[..., None] * rng.normal(1, 0.3, size=16)
             + 0.5 * rng.normal(size=(8, 6, 5, 16))).astype(np.float32)
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n) for n in (9, 10, 11)),
                             indexing="ij")
    vol = np.exp(-3 * (xx ** 2 + yy ** 2 + zz ** 2)).astype(np.float32)
    return {"stack": stack, "ref": stack[2, 3, 1].copy(), "vol": vol,
            "vol8": stack[..., 0].copy(), "iso": _smooth(rng, (9, 10, 11)),
            "iso_even": _smooth(rng, (8, 8, 12))}


def _smooth(rng, shape) -> np.ndarray:
    """A smooth random volume (separable box blurs of uniform noise)."""
    v = rng.uniform(size=shape)
    for axis in range(3):
        v = (np.roll(v, 1, axis) + v + np.roll(v, -1, axis)) / 3.0
    return v.astype(np.float32)


def iso_value(vol: np.ndarray) -> float:
    return float(np.quantile(vol, 0.6))


def _save(out: dict, key: str, t) -> None:
    out[key] = t.detach().cpu().numpy() if torch.is_tensor(t) else t


def _checks(space: int, members: int, data: dict, tmp: str, out: dict):
    from correrender_tpu_torch.calculators.noise import gaussian_blur_3d
    from correrender_tpu_torch.io.writers import write_netcdf
    from correrender_tpu_torch.parallel import (
        correlate_member_sharded,
        correlate_space_sharded,
        dvr_shearwarp_sharded,
        exchange_halo_z,
        gather_member_stack,
        gather_z,
        gaussian_blur_3d_sharded,
        iso_shearwarp_sharded,
        make_mesh,
        pearson_member_sharded,
        reshard_member_to_space,
        reshard_space_to_member,
        shard_member_stack,
        space_only_mesh,
    )
    from correrender_tpu_torch.parallel.mesh import (
        block_range,
        shard_member_series,
    )
    from correrender_tpu_torch.render.camera import Camera
    from correrender_tpu_torch.render.tf import TransferFunction

    tag = f"{space}x{members}/"
    mesh = make_mesh(space, members, device_type="cpu")
    stack = torch.from_numpy(data["stack"])
    ref = torch.from_numpy(data["ref"])
    block = shard_member_stack(stack, mesh)
    ref_block = shard_member_series(ref, mesh)
    _save(out, tag + "stack_equal", bool(torch.equal(
        gather_member_stack(block, mesh), stack)))

    def whole(field):
        return gather_z(field, mesh)

    _save(out, tag + "pearson", whole(pearson_member_sharded(
        block, ref_block, mesh)))
    for label, measure, kw in MEMBER_MEASURES:
        _save(out, tag + label, whole(correlate_member_sharded(
            block, ref_block, mesh, measure, **kw)))

    # The reshard round trip, and the space layout's measures.
    sblock, smesh = reshard_member_to_space(block, mesh)
    z0, z1 = block_range(stack.shape[0], space * members,
                         dist.get_rank())
    _save(out, tag + "space_block_equal", bool(torch.equal(
        sblock, stack[z0:z1])))
    _save(out, tag + "round_trip_equal", bool(torch.equal(
        reshard_space_to_member(sblock, smesh), block)))
    flat = space_only_mesh(mesh)
    for measure in SPACE_MEASURES:
        kw = {"num_bins": 8} if measure == "mi_binned" else {}
        _save(out, tag + "space_" + measure, gather_z(correlate_space_sharded(
            sblock, ref, smesh, measure, **kw), flat))
    try:
        reshard_member_to_space(block[:1], mesh)
        _save(out, tag + "reshard_error", "")
    except ValueError as exc:
        _save(out, tag + "reshard_error", str(exc))

    # The halo exchange and the sharded blur, over space.
    vol8 = torch.from_numpy(data["vol8"])
    zb0, zb1 = block_range(vol8.shape[0], space, mesh.get_local_rank(
        "space"))
    vblock = vol8[zb0:zb1]
    for halo in (1, 2):
        if halo <= vblock.shape[0]:
            _save(out, tag + f"halo{halo}_r{dist.get_rank()}",
                  exchange_halo_z(vblock, halo, mesh))
    try:
        exchange_halo_z(vblock, vol8.shape[0] // space + 1, mesh)
        _save(out, tag + "halo_error", "")
    except ValueError as exc:
        _save(out, tag + "halo_error", str(exc))
    for sigma in blur_sigmas(space):
        _save(out, tag + f"blur{sigma}",
              whole(gaussian_blur_3d_sharded(vblock, sigma, mesh)))
        _save(out, tag + f"blur{sigma}_dense", gaussian_blur_3d(vol8, sigma))

    # The sharded shear-warp: 9 planes over the space axis.
    vol = torch.from_numpy(data["vol"])
    v0, v1 = block_range(vol.shape[0], space, mesh.get_local_rank("space"))
    tf = TransferFunction.from_colormap("coolwarm", domain=(0.0, 1.0),
                                        opacity_points=((0.0, 0.0),
                                                        (1.0, 0.9)))
    for name, pos in CAMERAS.items():
        frame = dvr_shearwarp_sharded(vol[v0:v1], Camera(position=pos), tf,
                                      mesh, image_size=IMAGE,
                                      background=(0, 0, 0, 0))
        _save(out, tag + f"dvr_{name}_r{dist.get_rank()}", frame)

    # The sharded isosurface, over space.
    for name, (vname, pos, ss) in ISO_CASES.items():
        v = torch.from_numpy(data[vname])
        i0, i1 = block_range(v.shape[0], space, mesh.get_local_rank("space"))
        frame = iso_shearwarp_sharded(
            v[i0:i1], Camera(position=pos), iso_value(data[vname]), mesh,
            image_size=ISO_IMAGE, background=(0, 0, 0, 0),
            axial_supersample=ss)
        _save(out, tag + f"iso_{name}_r{dist.get_rank()}", frame)

    # The multi-process helpers, one device a rank.
    _multihost(mesh, stack, tag, out)

    # The export, written by rank 0 and read back by the test.
    field = whole(pearson_member_sharded(block, ref_block, mesh))
    if dist.get_rank() == 0:
        write_netcdf(os.path.join(tmp, f"field_{space}x{members}.nc"),
                     field.numpy(), name="pearson")
    dist.barrier()


def _multihost(mesh, stack, tag: str, out: dict) -> None:
    from correrender_tpu_torch.parallel import (
        member_series_from_local,
        member_stack_from_local,
        process_member_range,
        replicate_to_host,
        shard_member_stack,
    )

    r = dist.get_rank()
    e = stack.shape[-1]
    lo, hi = process_member_range(mesh, e)
    _save(out, tag + f"member_range_r{r}", np.array([lo, hi]))
    try:
        process_member_range(mesh, e - 7)
        _save(out, tag + "member_range_error", "")
    except ValueError as exc:
        _save(out, tag + "member_range_error", str(exc))
    local = stack.numpy()[..., lo:hi]  # this process's members, whole Z
    block = member_stack_from_local(local, mesh, e)
    _save(out, tag + f"local_stack_equal_r{r}", bool(torch.equal(
        block, shard_member_stack(stack, mesh))))
    series = np.arange(e, dtype=np.float32)
    sblock = member_series_from_local(series[lo:hi], mesh, e)
    _save(out, tag + "replicated_stack", replicate_to_host(block, mesh))
    _save(out, tag + "replicated_series", replicate_to_host(sblock, mesh))
    try:
        member_stack_from_local(local[..., :-1], mesh, e)
        _save(out, tag + "local_stack_error", "")
    except ValueError as exc:
        _save(out, tag + "local_stack_error", str(exc))


def _spanning_mesh_error(world: int, out: dict) -> None:
    from correrender_tpu_torch.parallel import process_spanning_mesh

    try:
        process_spanning_mesh(world, 2, device_type="cpu")
        _save(out, "spanning_mesh_error", "")
    except ValueError as exc:
        _save(out, "spanning_mesh_error", str(exc))


def _stress(world: int, out: dict) -> None:
    """The stress runs at tiny sizes, their stacks and the fields of the
    stressed program on them."""
    from correrender_tpu_torch.parallel import (
        correlate_space_sharded,
        gather_member_stack,
        gather_z,
        make_mesh,
        space_only_mesh,
        stress_pearson,
        stress_rank_ksg,
        stress_reshard,
    )
    from correrender_tpu_torch.parallel.stress import rank_stack

    shape = (world // 2, 2)
    kw = dict(grid=STRESS_GRID, members=STRESS_MEMBERS, device="cpu")
    for dtype in ("float32", "bfloat16"):
        row = stress_pearson(mesh_shape=shape, dtype=dtype,
                             check_fraction=1.0, **kw)
        _save(out, f"stress/pearson_{dtype}", json.dumps(row))
    _save(out, "stress/reshard", json.dumps(stress_reshard(
        mesh_shape=shape, **kw)))
    for measure, mkw in STRESS_MEASURES.items():
        _save(out, f"stress/{measure}", json.dumps(stress_rank_ksg(
            measure, **kw, **mkw)))
    mesh = make_mesh(*shape, device_type="cpu")
    for seed in (13, 14):
        _save(out, f"stress/stack{seed}", gather_member_stack(rank_stack(
            STRESS_GRID, STRESS_MEMBERS, mesh, seed=seed), mesh))
    # The stressed program's fields on stress_rank_ksg's stack and series.
    smesh = make_mesh(members=1, device_type="cpu")
    block = rank_stack(STRESS_GRID, STRESS_MEMBERS, smesh, seed=13)
    gen = torch.Generator().manual_seed(14)
    ref = torch.randn((STRESS_MEMBERS,), generator=gen)
    for measure, mkw in STRESS_MEASURES.items():
        _save(out, f"stress/field_{measure}", gather_z(
            correlate_space_sharded(block, ref, smesh, measure, **mkw),
            space_only_mesh(smesh)))


def mesh_error_cases(world: int):
    """(space, members, device type) meshes ``make_mesh`` refuses on a
    gloo group of ``world`` ranks."""
    return ((world + 1, 1, "cpu"), (0, 1, "cpu"), (1, world + 1, "cpu"),
            (1, 1, "cpu"), (world, 1, "cuda"))


def _mesh_errors(world: int, out: dict) -> None:
    from correrender_tpu_torch.parallel import make_mesh

    for space, members, device_type in mesh_error_cases(world):
        try:
            make_mesh(space, members, device_type=device_type)
            message = ""
        except ValueError as exc:
            message = str(exc)
        _save(out, f"mesh_error/{space}x{members}/{device_type}", message)


def _config5(tmp: str, out: dict) -> None:
    from correrender_tpu_torch.app.baseline_configs import (
        config5_sharded_batch_render,
    )
    from correrender_tpu_torch.parallel import gather_z

    res = config5_sharded_batch_render(grid=CONFIG5_GRID, members=8,
                                       device="cpu", tmp_dir=tmp)
    _save(out, "config5/field", gather_z(res["field"], res["mesh"]))
    for i, frame in enumerate(res["frames"]):
        _save(out, f"config5/frame{i}_r{dist.get_rank()}", frame)
    _save(out, "config5/keys", " ".join(sorted(res)))
    _save(out, "config5/export_bytes", res["export_bytes"])
    _save(out, "config5/export_path", res["export_path"])


def run(rank: int, world: int, tmp: str) -> None:
    """One rank: join the group, run the checks of every mesh of this
    world size and config 5, save ``rank<r>.npz`` under ``tmp``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        data = inputs()
        out: dict = {}
        for space, members in MESHES[world]:
            _checks(space, members, data, tmp, out)
        _mesh_errors(world, out)
        _spanning_mesh_error(world, out)
        _stress(world, out)
        _config5(tmp, out)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
