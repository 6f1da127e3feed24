"""Multi-process (multi-host) meshes and per-process data loading.

Counterpart of ``correrender_tpu/parallel/multihost.py``. A production
ensemble spans processes: every process loads only its own part of the
ensemble from the store, and the processes form one mesh whose
collectives cross process (and host) boundaries.

In the JAX package one process drives many devices and the member
columns of its mesh are process-local. Here **each process drives one
device** (the model of ``torch.distributed``: one rank a GPU), so a
process's part of the ensemble is its rank's block: the members of its
``members`` coordinate over the Z-planes of its ``space`` coordinate.
A rank reads only those members from the store and cuts its Z-block;
nothing is exchanged between processes to assemble the stack.

* :func:`initialize_process` joins the process group: through
  ``env://`` as ``torchrun`` sets it up, or through ``tcp://`` with a
  coordinator address, a process count and an id. NCCL on the card,
  gloo on the CPU.
* :func:`process_spanning_mesh` is the ``(space, members)`` mesh over
  every process (``mesh.make_mesh``'s rank order).
* :func:`process_member_range`, :func:`member_stack_from_local` and
  :func:`member_series_from_local` give a rank its members and blocks.
* :func:`replicate_to_host` gathers blocks to every process as numpy.

``multihost_worker.py`` runs the whole path in each process, and its
``launch`` starts N local processes.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from correrender_tpu_torch.parallel.mesh import (
    axis_size,
    backend_for,
    block_range,
    gather_member_stack,
    gather_members,
    gather_z,
    make_mesh,
    mesh_device,
    space_only_mesh,
)


#: Seconds a collective (the join included) may wait for another
#: process before it raises.
_JOIN_TIMEOUT_S = 300


def initialize_process(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_devices: int | None = None,
    platform: str = "cuda",
) -> torch.device:
    """Join the process group and return this process's device.

    With no ``coordinator`` the group is joined through ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, as
    ``torchrun`` sets them); with ``coordinator="host:port"`` through
    ``tcp://``, with ``num_processes`` and ``process_id``. The backend
    follows ``platform``: NCCL for ``"cuda"``, gloo for ``"cpu"``. On the
    card the process takes GPU ``LOCAL_RANK`` (or its id modulo the
    visible GPUs). ``local_devices`` is accepted for the JAX package's
    signature and ignored: a process drives one device.
    """
    del local_devices
    backend = backend_for(platform)
    timeout = datetime.timedelta(seconds=_JOIN_TIMEOUT_S)
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=timeout)
    if platform == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        return torch.device("cuda", local)
    return torch.device(platform)


def process_spanning_mesh(space: int, members: int,
                          device_type: str = "cuda"):
    """The ``(space, members)`` mesh over every process of the group,
    one device each (rank = space index × members + member index)."""
    n = dist.get_world_size()
    if space * members != n:
        raise ValueError(f"mesh {space}x{members} != {n} global devices")
    return make_mesh(space, members, device_type=device_type)


def process_member_range(mesh, num_members: int) -> tuple[int, int]:
    """Member index range ``[lo, hi)`` this process must load: its
    rank's block of the ``members`` axis."""
    members = axis_size(mesh, "members")
    if num_members % members:
        raise ValueError(
            f"E={num_members} not divisible by members={members}")
    block = num_members // members
    m = mesh.get_local_rank("members")
    return m * block, (m + 1) * block


def member_stack_from_local(local_stack, mesh,
                            num_members: int) -> torch.Tensor:
    """The rank's ``(Zb, Y, X, Eb)`` block of the member-sharded stack
    from this process's members.

    ``local_stack``: ``(Z, Y, X, E_local)`` (numpy or a tensor, any
    strides), the members of :func:`process_member_range` over the full
    spatial extent; the rank keeps its Z-block, on its device.
    """
    lo, hi = process_member_range(mesh, num_members)
    if local_stack.shape[-1] != hi - lo:
        raise ValueError(
            f"local stack has {local_stack.shape[-1]} members, "
            f"process range is [{lo}, {hi})")
    z0, z1 = block_range(local_stack.shape[0], axis_size(mesh, "space"),
                         mesh.get_local_rank("space"))
    block = local_stack[z0:z1]
    if isinstance(block, np.ndarray):
        block = torch.from_numpy(block)  # a view, whatever its strides
    # A member-major view (members stacked first, then moved last) is
    # copied to the device as it lies and made contiguous there.
    return block.to(mesh_device(mesh)).contiguous()


def member_series_from_local(local_series, mesh,
                             num_members: int) -> torch.Tensor:
    """The rank's ``(Eb,)`` block of a member-sharded series (e.g. the
    reference point's) from this process's members."""
    lo, hi = process_member_range(mesh, num_members)
    if len(local_series) != hi - lo:
        raise ValueError("series length != process member range")
    return torch.as_tensor(np.ascontiguousarray(local_series)).to(
        mesh_device(mesh))


#: How :func:`replicate_to_host` assembles a block, by layout.
_LAYOUTS = {
    "stack": lambda b, mesh: gather_member_stack(b, mesh),
    "field": lambda b, mesh: gather_z(b, mesh, "space"),
    "series": lambda b, mesh: gather_members(b, mesh),
    "space": lambda b, mesh: gather_z(b, space_only_mesh(mesh)),
}


def replicate_to_host(block: torch.Tensor, mesh,
                      layout: str | None = None) -> np.ndarray:
    """Gather a sharded array to every process, as numpy.

    ``layout`` says how the blocks lie: ``"stack"`` (Z over ``space``, E
    over ``members``), ``"field"`` (Z over ``space``), ``"series"`` (E
    over ``members``) or ``"space"`` (Z over every rank in order, the
    layout after ``reshard_member_to_space``). By default a 1-D block
    is a series, a 3-D one a field and a 4-D one a stack. Every process
    must call it (it runs collectives).
    """
    if layout is None:
        layout = {1: "series", 3: "field", 4: "stack"}[block.ndim]
    return _LAYOUTS[layout](block, mesh).cpu().numpy()
