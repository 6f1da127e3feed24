"""Multi-rank shear-warp isosurface rendering of a Z-sharded volume.

Counterpart of ``correrender_tpu/parallel/iso_sharded.py``. "First hit
along the ray" is an associative fold like OVER, so it factors across
ranks as ``dvr_sharded.py`` factors compositing:

* the scalars are redistributed along the camera's principal axis (one
  ``all_to_all_single``, none for a Z-principal camera whose Z-blocks
  are the slabs already), ``ceil(S / N)`` slices a rank, and each rank
  builds the 4-channel (value, world-space gradient) slab of its own
  slices with a one-plane halo from ``halo.exchange_halo_z``: the
  gradient is one-sided at the volume's first and last planes and
  equals the dense ``iso_fast.gradient_volume`` bit for bit;
* each rank runs the first-hit scan (``render/iso_fast.py``) over its
  slab, prefixed with a ONE-SLICE HALO of the previous rank in near →
  far order, so a crossing that spans two slabs is found by exactly one
  rank; the nearest rank's halo has g = 0 and the scan's inside-gate
  rejects it;
* the ``(found, gradient)`` intermediate images are all-gathered (the
  masks as ``uint8``, the gradients as one float32 buffer) and combined
  near → far, the first found winning;
* Blinn-Phong shading and the homography warp
  (``iso_fast.shade_and_warp``) run on every rank.

A slab past the volume's end is padded with inert slices (g = −1), as
the JAX package pads. An eye inside the principal-axis slab gathers the
volume and renders it with the dense ``iso_shearwarp``.

The JAX package computes the gradient on the Z-sharded volume and
reshards the 4-channel volume; here the scalars are resharded (a
quarter of the bytes) and the slab is built after the reshard.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.parallel.dvr_sharded import slab_along
from correrender_tpu_torch.parallel.halo import exchange_halo_z
from correrender_tpu_torch.parallel.mesh import (
    all_gather_ints,
    all_gather_stacked,
    axis_size,
    gather_z,
)
from correrender_tpu_torch.render.camera import default_render_box
from correrender_tpu_torch.render.dvr_fast import (
    shearwarp_axes,
    shearwarp_geometry,
    shearwarp_viable,
    slice_perm,
)
from correrender_tpu_torch.render.iso_fast import (
    axial_interleave,
    first_hit_scan,
    gradient_volume,
    iso_shearwarp,
    shade_and_warp,
)


def _valid_subslabs(g: np.ndarray, m: int) -> np.ndarray:
    """Which slices of an m× supersampled sequence are live, from the
    per-slice g of the original one (JAX's ``_interleave_g``): slice k
    itself when g_k > 0, a sub-slab after it only when g_k and g_{k+1}
    are both > 0. Sub-slabs next to an invalid slice (the missing first
    halo, padding) are rejected, as the dense path has no
    predecessor."""
    ok = g > 0.0
    body = np.repeat((ok[:-1] & ok[1:])[:, None], m, axis=1)
    body[:, 0] = ok[:-1]
    return np.append(body.reshape(-1), ok[-1])


def iso_shearwarp_sharded(
    volume: torch.Tensor,
    camera,
    iso_value: float,
    mesh,
    surface_color=(0.9, 0.4, 0.2, 1.0),
    image_size=(1920, 1080),
    box=None,
    background=(0.0, 0.0, 0.0, 1.0),
    intermediate_scale: float = 1.0,
    axis_name: str = "space",
    axial_supersample: int = 1,
) -> torch.Tensor:
    """Render the isosurface of a Z-sharded volume across ranks.

    Args:
      volume: the rank's ``(Zb, Y, X)`` float32 block of the field, Z
        split over ``axis_name`` in rank order (blocks of any size).
      camera, iso_value, surface_color, image_size, box, background,
        intermediate_scale, axial_supersample: as
        ``iso_fast.iso_shearwarp``; ``box`` defaults to the whole
        volume's. Each rank interleaves the supersampled sub-slabs after
        the halo, so midpoints across two slabs use the true neighbour.
      mesh: the mesh whose ``axis_name`` shards Z.

    Returns:
      The ``(H, W, 4)`` straight-alpha frame, the same on every rank of
      the axis.
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
        return iso_shearwarp(gather_z(volume, mesh, axis_name), camera,
                             iso_value, surface_color=surface_color,
                             image_size=image_size, box=box,
                             background=background,
                             intermediate_scale=intermediate_scale,
                             axial_supersample=axial_supersample)

    eye, a, in_plane, flip = shearwarp_axes(camera)
    perm = slice_perm(a, in_plane)
    axis = perm[0]  # the array axis of the slices
    dims = (zs, ys, xs)
    s, nv, nu = (dims[p] for p in perm)
    slab = -(-s // n)
    geo = shearwarp_geometry(camera, box_min, box_max, a, in_plane, flip,
                             s, nv, nu, image_size, intermediate_scale,
                             device=dev)

    # The rank's slices, slice axis first, padded to a whole slab, with
    # a neighbour's plane on each side for the gradient.
    local = slab_along(volume, z_sizes, idx, n, axis, slab, group)
    if local.shape[0] < slab:
        local = torch.cat([local, local.new_zeros(
            (slab - local.shape[0],) + tuple(local.shape[1:]))])
    haloed = exchange_halo_z(local.contiguous(), 1, mesh, axis_name)
    grad = gradient_volume(haloed.movedim(0, axis), box_min, box_max,
                            halo_axis=axis, rows=(idx * slab, s))
    values = local.movedim(0, axis)
    cvol = torch.cat([values[..., None], grad], dim=-1).permute(*perm, 3)
    cvol = cvol.contiguous()  # (slab, nv, nu, 4) in array order

    # g in array order, padded with inert slices past the volume's end.
    g = np.asarray(geo["g"], np.float32)
    g_up = np.concatenate([g[::-1] if flip else g,
                           np.full(slab * n - s, -1.0, np.float32)])
    g_loc = g_up[idx * slab:(idx + 1) * slab]
    # The near-side halo: the slice before this slab in near → far order,
    # none (g = 0) on the nearest rank.
    near = exchange_halo_z(cvol, 1, mesh, axis_name)
    if flip:
        halo = near[-1:]
        halo_g = g_up[(idx + 1) * slab] if idx < n - 1 else 0.0
        cvol, g_loc = cvol.flip(0), g_loc[::-1]
        first = idx == n - 1
    else:
        halo = near[:1]
        halo_g = g_up[idx * slab - 1] if idx > 0 else 0.0
        first = idx == 0
    if first:
        halo = torch.zeros_like(halo)
    cvol_h = torch.cat([halo, cvol])
    g_h = np.concatenate([np.float32([halo_g]), g_loc]).astype(np.float32)
    m = int(axial_supersample)
    if m > 1 and s > 1:
        cvol_h = axial_interleave(cvol_h, m)
        # Which sub-slabs are live follows JAX's interleave; their g is
        # the dense path's subdivision of the global slice coordinate
        # (iso_fast.iso_shearwarp), so the frame equals the dense one.
        valid = _valid_subslabs(g_h, m)
        k0 = s - (idx + 1) * slab if flip else idx * slab  # near → far
        sub = (k0 - 1) * m + np.arange(valid.shape[0])
        g0 = geo["g"]
        g_h = np.where(valid, g0[0] + sub * ((g0[1] - g0[0]) / m),
                       -1.0).astype(np.float32)
    found, _, grad_hit = first_hit_scan(
        cvol_h, g_h, geo["coords_v"], geo["coords_u"], geo["grid_v"],
        geo["grid_u"], (geo["e_u"], geo["e_v"]), iso_value,
        ip0=in_plane[0], ip1=in_plane[1], ax=a)

    founds = all_gather_stacked(found.to(torch.uint8), group).bool()
    grads = all_gather_stacked(grad_hit, group)
    acc_found = torch.zeros_like(found)
    acc_grad = torch.zeros_like(grad_hit)
    for i in (range(n - 1, -1, -1) if flip else range(n)):  # near → far
        take = founds[i] & ~acc_found
        acc_grad = torch.where(take[..., None], grads[i], acc_grad)
        acc_found = acc_found | founds[i]
    width, height = image_size
    return shade_and_warp(acc_found, acc_grad, camera, geo["grid_u"],
                          geo["grid_v"], in_plane, a, eye, geo["z_ref"],
                          surface_color, background, width, height)
