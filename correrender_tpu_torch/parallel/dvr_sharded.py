"""Multi-rank shear-warp DVR of a Z-sharded volume.

Counterpart of ``correrender_tpu/parallel/dvr_sharded.py``. The
shear-warp composite is a front-to-back OVER fold over slices, and OVER
is associative, so it factors across ranks: each rank composites its
own slab of slices onto the shared intermediate grid with K3
(``shearwarp_composite``), the ``(Hi, Wi, 4)`` partial images are
all-gathered and OVER-combined in slab order (reversed when the slices
run far → near), and the combined intermediate goes through
``dvr_fast.warp_to_screen`` on every rank.

The slabs run along the camera's principal axis, ``ceil(S / N)`` slices
a rank; a rank whose slab runs past the volume pads inert slices (no
opacity, g = −1, which K3 skips), as the JAX package does. A camera
whose principal axis is not Z redistributes the volume over that axis
with one ``all_to_all_single``; an eye-inside camera gathers the volume
and renders it whole with ``dvr_shearwarp``.

Classification: the JAX package classifies the Z-sharded volume with B3
(``classify_volume``) and reshards the RGBA volume. Here the scalars are
resharded (a quarter of the bytes) and each rank classifies its slab
with K2 (``classify_to_cf``) straight into K3's layout. Classification
is per voxel, so both give the same function; K2 and B3 differ by up to
one bf16 rounding of the classified values, K3's input precision.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from correrender_tpu_torch.ops.cuda.shearwarp_kernel import (
    classify_to_cf,
    shearwarp_composite,
)
from correrender_tpu_torch.parallel.mesh import (
    all_gather_ints,
    all_gather_stacked,
    axis_size,
    gather_z,
)
from correrender_tpu_torch.render.camera import default_render_box
from correrender_tpu_torch.render.dvr_fast import (
    composite_inputs,
    dvr_shearwarp,
    shearwarp_axes,
    shearwarp_geometry,
    shearwarp_viable,
    slice_perm,
    warp_to_screen,
)


def slab_along(block, z_sizes, idx, n, axis, slab, group):
    """This rank's slices ``[idx·slab, (idx + 1)·slab)`` of the global
    volume along array ``axis``, whole along the other two, from the
    ranks' Z-blocks of ``z_sizes`` planes: one ``all_to_all_single``
    (none on one rank). Returns the slab with ``axis`` first, then the
    remaining axes in order; it is shorter than ``slab`` past the
    volume's end."""
    moved = block.movedim(axis, 0)
    if n == 1:
        return moved
    z_starts = np.cumsum([0] + list(z_sizes)).tolist()
    s = z_starts[-1] if axis == 0 else moved.shape[0]
    lo, hi = min(idx * slab, s), min((idx + 1) * slab, s)
    # Elements of one z plane (axis 0) or one (slice, z) line (else).
    unit = int(np.prod(moved.shape[1:] if axis == 0 else moved.shape[2:]))
    sends, send_sizes, recv_sizes = [], [], []
    for j in range(n):
        j_lo, j_hi = min(j * slab, s), min((j + 1) * slab, s)
        if axis == 0:  # this block's rows in rank j's slab; j's in ours
            z0 = z_starts[idx]
            r0 = min(max(j_lo - z0, 0), block.shape[0])
            r1 = min(max(j_hi - z0, r0), block.shape[0])
            piece = moved[r0:r1]
            zj0, zj1 = z_starts[j], z_starts[j + 1]
            recv_sizes.append(max(min(hi, zj1) - max(lo, zj0), 0) * unit)
        else:  # rank j's slices of this block; our slices of j's block
            piece = moved[j_lo:j_hi]
            recv_sizes.append((hi - lo) * z_sizes[j] * unit)
        sends.append(piece.reshape(-1))
        send_sizes.append(piece.numel())
    send = torch.cat(sends)
    recv = send.new_empty(sum(recv_sizes))
    dist.all_to_all_single(recv, send, recv_sizes, send_sizes, group=group)
    if axis == 0:
        return recv.reshape((-1,) + tuple(moved.shape[1:]))
    return torch.cat([p.reshape((hi - lo, zi) + tuple(moved.shape[2:]))
                      for p, zi in zip(recv.split(recv_sizes), z_sizes)],
                     dim=1)


def dvr_shearwarp_sharded(
    volume: torch.Tensor,
    camera,
    transfer_function,
    mesh,
    image_size=(1920, 1080),
    box=None,
    attenuation: float = 100.0,
    background=(0.0, 0.0, 0.0, 1.0),
    intermediate_scale: float = 1.0,
    axis_name: str = "space",
) -> torch.Tensor:
    """Render a Z-sharded volume with distributed shear-warp DVR.

    Args:
      volume: the rank's ``(Zb, Y, X)`` float32 block of the field, Z
        split over ``axis_name`` in rank order (blocks of any size).
      camera, transfer_function, image_size, box, attenuation,
        background, intermediate_scale: as ``dvr_fast.dvr_shearwarp``;
        ``box`` defaults to the whole volume's.
      mesh: the mesh whose ``axis_name`` shards Z.

    Returns:
      The ``(H, W, 4)`` frame, the same on every rank of the axis.
    """
    group = mesh.get_group(axis_name)
    n, idx = axis_size(mesh, axis_name), mesh.get_local_rank(axis_name)
    dev = volume.device
    z_sizes = ([volume.shape[0]] if n == 1 else
               [s[0] for s in all_gather_ints([volume.shape[0]], group,
                                              dev)])
    zs, ys, xs = sum(z_sizes), volume.shape[1], volume.shape[2]
    if box is None:
        box = default_render_box((zs, ys, xs))
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    if not shearwarp_viable(camera, (box_min, box_max)):
        return dvr_shearwarp(gather_z(volume, mesh, axis_name), camera,
                             transfer_function, image_size=image_size,
                             box=box, attenuation=attenuation,
                             background=background,
                             intermediate_scale=intermediate_scale)

    eye, a, in_plane, flip = shearwarp_axes(camera)
    perm = slice_perm(a, in_plane)
    dims = (zs, ys, xs)
    s, nv, nu = (dims[p] for p in perm)
    slab = -(-s // n)
    geo = shearwarp_geometry(camera, box_min, box_max, a, in_plane, flip,
                             s, nv, nu, image_size, intermediate_scale,
                             device=dev)
    local = slab_along(volume, z_sizes, idx, n, perm[0], slab, group)
    order = [perm[0]] + [ax for ax in range(3) if ax != perm[0]]
    local = local.permute(*(order.index(p) for p in perm))
    if local.shape[0] < slab:  # inert slices past the volume's end
        local = torch.cat([local, local.new_full(
            (slab - local.shape[0], nv, nu), float("nan"))])
    # geo's g runs near → far; the slabs take it in array order, padded
    # with inert slices.
    g = np.asarray(geo["g"], np.float32)
    g_up = np.concatenate([g[::-1] if flip else g,
                           np.full(slab * n - s, -1.0, np.float32)])
    g_loc = g_up[idx * slab:(idx + 1) * slab]
    cf = classify_to_cf(local, (0, 1, 2), flip, transfer_function.lut,
                        transfer_function.domain)
    inputs = composite_inputs(geo, dev)
    inputs["g"] = torch.as_tensor(np.ascontiguousarray(
        g_loc[::-1] if flip else g_loc), device=dev)
    rgb, alpha = shearwarp_composite(cf, **inputs, attenuation=attenuation)
    parts = all_gather_stacked(torch.cat([rgb, alpha[..., None]], -1), group)
    acc_rgb = torch.zeros_like(rgb)
    acc_a = torch.zeros_like(alpha)
    for i in (range(n - 1, -1, -1) if flip else range(n)):  # near → far
        w = 1.0 - acc_a
        acc_rgb = acc_rgb + w[..., None] * parts[i, ..., :3]
        acc_a = acc_a + w * parts[i, ..., 3]
    width, height = image_size
    return warp_to_screen(acc_rgb, acc_a, camera, width, height, in_plane,
                          a, eye, geo["z_ref"], geo["grid_u"],
                          geo["grid_v"], background)
