"""Device meshes over ``torch.distributed`` ranks, local blocks, and the
member ↔ space reshards.

Counterpart of ``correrender_tpu/parallel/mesh.py``. The canonical
member-stack layout is ``(Z, Y, X, E)`` on a 2D ``(space, members)``
mesh: ``space`` shards Z (voxel-parallel), ``members`` shards E (the
estimators reduce or gather across it, ``pearson_sharded.py``).

The JAX package hands a global array with a sharding to ``shard_map``.
Here every function takes and returns the rank's **local block**, and
the collectives run on the mesh's sub-groups by hand: a block is what
the kernels read, so its layout is never hidden behind a ``DTensor``.
:func:`shard_member_stack` cuts a rank's block from a global stack and
:func:`gather_z` / :func:`gather_member_stack` assemble the global
tensor again (for tests and export).

Blocks along an axis of ``size`` over ``parts`` ranks are of
``ceil(size / parts)``, the last ones shorter (possibly empty), as JAX
lays out an uneven sharding. A mesh spans every rank of the process
group, in rank order (rank = space index × members + member index). The
backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device_type: str) -> str:
    """The process-group backend of a device type: NCCL on the card,
    gloo on the CPU, nothing else."""
    if device_type not in _BACKENDS:
        raise ValueError(f"no process-group backend for {device_type!r}")
    return _BACKENDS[device_type]


def init_single_rank(device_type: str = "cuda") -> None:
    """Start a one-rank process group (an in-memory store, no file or
    port) unless one is running: the mesh of a program on one device."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device_type),
                                store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(space: int | None = None, members: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Build a ``(space, members)`` mesh over the process group's ranks
    (a one-rank group is started if none is running)."""
    init_single_rank(device_type)
    n = dist.get_world_size()
    if space is None:
        space = n // members
    if space < 1 or members < 1 or space * members > n:
        raise ValueError(f"mesh {space}x{members} > {n} devices")
    if space * members < n:
        raise ValueError(
            f"mesh {space}x{members} leaves ranks of the {n}-rank process "
            "group out; a mesh spans every rank")
    backend = dist.get_backend()
    if backend != backend_for(device_type):
        raise ValueError(f"a {device_type} mesh needs the "
                         f"{backend_for(device_type)} backend, the process "
                         f"group runs {backend}")
    return init_device_mesh(device_type, (space, members),
                            mesh_dim_names=("space", "members"))


def space_only_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """A 1-D ``("space",)`` mesh over the same ranks in order, so a 2-D
    mesh's ranks hold Z row-major over both axes (the layout of
    :func:`reshard_member_to_space`)."""
    return DeviceMesh(mesh.device_type, mesh.mesh.flatten(),
                      mesh_dim_names=("space",))


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device a rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def whole_mesh_group(mesh: DeviceMesh):
    """The group of every rank of the mesh (which spans the process
    group)."""
    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


def block_range(size: int, parts: int, index: int) -> tuple[int, int]:
    """``[start, stop)`` of block ``index`` of ``size`` over ``parts``
    ranks: blocks of ``ceil(size / parts)``, the last ones shorter."""
    step = -(-size // parts)
    start = min(index * step, size)
    return start, min(start + step, size)


def all_gather_ints(values, group, device) -> list[list[int]]:
    """Every rank's list of ints (one host sync)."""
    mine = torch.tensor(list(values), dtype=torch.int64, device=device)
    return all_gather_stacked(mine, group).tolist()


def all_gather_stacked(t: torch.Tensor, group) -> torch.Tensor:
    """``(ranks, *t.shape)``: an equally shaped tensor from every rank of
    ``group``, in group order."""
    ranks = dist.get_world_size(group)
    if ranks == 1:
        return t[None]
    out = t.new_empty(ranks * t.numel())
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1), group=group)
    return out.reshape((ranks,) + tuple(t.shape))


def gather_z(block: torch.Tensor, mesh: DeviceMesh,
             axis_name: str = "space") -> torch.Tensor:
    """The global tensor of Z-blocks (any sizes) over a mesh axis, on
    every rank of it."""
    group = mesh.get_group(axis_name)
    if dist.get_world_size(group) == 1:
        return block
    sizes = [s[0] for s in all_gather_ints([block.shape[0]], group,
                                           block.device)]
    padded = block.new_zeros((max(sizes),) + tuple(block.shape[1:]))
    padded[:block.shape[0]] = block
    parts = all_gather_stacked(padded, group)
    return torch.cat([parts[i, :s] for i, s in enumerate(sizes)])


def shard_member_stack(stack: torch.Tensor, mesh: DeviceMesh):
    """The rank's block of a global ``(Z, Y, X, E)`` stack: Z over
    ``space`` (uneven blocks allowed), E over ``members`` (even), moved
    to the mesh's device."""
    space, members = (axis_size(mesh, a) for a in ("space", "members"))
    zs, e = stack.shape[0], stack.shape[-1]
    if e % members:
        raise ValueError(f"E={e} not divisible by {members} member shards")
    z0, z1 = block_range(zs, space, mesh.get_local_rank("space"))
    eb = e // members
    m = mesh.get_local_rank("members")
    return stack[z0:z1, ..., m * eb:(m + 1) * eb].to(
        mesh_device(mesh)).contiguous()


def shard_member_series(ref: torch.Tensor, mesh: DeviceMesh):
    """The rank's block of an ``(E,)`` reference series (over
    ``members``)."""
    members = axis_size(mesh, "members")
    eb = ref.shape[0] // members
    m = mesh.get_local_rank("members")
    return ref[m * eb:(m + 1) * eb].to(mesh_device(mesh)).contiguous()


def gather_members(block: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``(..., E)`` from ``(..., E/members)`` blocks over ``members``."""
    group = mesh.get_group("members")
    parts = all_gather_stacked(block, group)  # (members, ..., Eb)
    if parts.shape[0] == 1:
        return block
    return torch.movedim(parts, 0, -2).reshape(
        tuple(block.shape[:-1]) + (-1,))


def gather_member_stack(block: torch.Tensor, mesh: DeviceMesh):
    """The global ``(Z, Y, X, E)`` stack of :func:`shard_member_stack`
    blocks, on every rank."""
    return gather_z(gather_members(block, mesh), mesh, "space")


def _z_total(zb: int, mesh: DeviceMesh, device) -> tuple[int, int, int]:
    """(global Z, smallest block, largest block) of the space axis, the
    same on every rank."""
    rows = all_gather_ints([zb], dist.group.WORLD, device)
    sizes = [r[0] for r in rows]
    members = axis_size(mesh, "members")
    return sum(sizes[::members]), min(sizes), max(sizes)


def reshard_member_to_space(block: torch.Tensor, mesh: DeviceMesh):
    """``(space, …, members)`` blocks → pure space blocks.

    Returns ``(block, mesh)``: the rank's ``(Z/(space·members), Y, X, E)``
    block, Z row-major over both mesh axes and the member axis whole, the
    layout rank and kNN measures need (``correlate_space_sharded``).
    One ``all_to_all_single`` over ``members``: each rank splits its Z
    block into ``members`` sub-slabs and swaps them for the other ranks'
    member slices. Z must be divisible by the rank count.
    """
    space, members = (axis_size(mesh, a) for a in ("space", "members"))
    n_total = space * members
    zs, lo, hi = _z_total(block.shape[0], mesh, block.device)
    if zs % n_total or lo != hi:
        raise ValueError(f"Z={zs} not divisible by {n_total} devices")
    if members == 1:
        return block, mesh
    zb = block.shape[0]
    send = block.contiguous().reshape(-1)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group("members"))
    parts = recv.reshape((members, zb // members) + tuple(block.shape[1:]))
    # parts[i]: member shard i's slice of this rank's sub-slab.
    return torch.movedim(parts, 0, -2).reshape(
        (zb // members,) + tuple(block.shape[1:-1]) + (-1,)), mesh


def reshard_space_to_member(block: torch.Tensor, mesh: DeviceMesh):
    """The inverse of :func:`reshard_member_to_space`: pure space blocks
    → ``(space, …, members)`` blocks, with the same ``all_to_all``."""
    members = axis_size(mesh, "members")
    if members == 1:
        return block
    zs_b, e = block.shape[0], block.shape[-1]
    if e % members:
        raise ValueError(f"E={e} not divisible by {members} member shards")
    # send[j] = member slice j of the whole sub-slab.
    send = torch.movedim(block.reshape(tuple(block.shape[:-1])
                                       + (members, e // members)), -2, 0)
    send = send.contiguous().reshape(-1)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group("members"))
    return recv.reshape((members * zs_b,) + tuple(block.shape[1:-1])
                        + (e // members,))
