"""The configurations' datasets, drawn on the device from the seed.

The planted-box ensemble of the reference application
(``scripts/generate_synth_box_ensembles.py``, ``linear=True``): each
voxel's member series is ``λ·s1 + (1 − λ)·s0`` with ``s0`` i.i.d.
normal and ``s1`` the shared ramp ``2·e/(E − 1) − 1``, where ``λ`` is
the sum of the 4×4 layout's box profiles at the voxel. Drawn
member-major, as a list of ``(E_c, Z, Y, X)`` float32 blocks.
"""

from __future__ import annotations

import torch


def _box_profile(dist: torch.Tensor) -> torch.Tensor:
    inner = torch.clamp_min(dist * 2.0 - 1.0, 0.0) ** 2
    return torch.where(dist >= 1.0, 0.0, 1.0 - inner)


def box_strength(xs: int, ys: int, zs: int, device) -> torch.Tensor:
    """``(Z, Y, X)`` float32 λ of the ten planted boxes (centre x, centre
    y, size in units of g = zs // 2; all centred at z = zs // 2)."""
    g = zs // 2
    boxes = [(g, g, 2.0 * g), (7 * g, 7 * g, 2.0 * g),
             (2.5 * g, 0.5 * g, g), (2.5 * g, 1.5 * g, g),
             (5.5 * g, 6.5 * g, g), (5.5 * g, 7.5 * g, g),
             (0.5 * g, 2.5 * g, g), (1.5 * g, 2.5 * g, g),
             (6.5 * g, 5.5 * g, g), (7.5 * g, 5.5 * g, g)]
    z = torch.arange(zs, dtype=torch.float32, device=device)[:, None, None]
    y = torch.arange(ys, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(xs, dtype=torch.float32, device=device)[None, None, :]
    lam = torch.zeros((zs, ys, xs), dtype=torch.float32, device=device)
    for cx, cy, size in boxes:
        dist = torch.maximum(torch.maximum((x - cx).abs(), (y - cy).abs()),
                             (z - g).abs()) / (size * 0.5)
        lam += _box_profile(dist)
    return lam


def planted_box(dataset: dict, chunk_members: int, seed: int, device):
    """The dataset as member-major float32 blocks of ``chunk_members``,
    drawn one after the other (a generator: the same seed gives the same
    blocks again)."""
    xs, ys, zs = dataset["xs"], dataset["ys"], dataset["zs"]
    members = dataset["members"]
    if not dataset.get("linear", True):
        raise ValueError("only the linear ramp (linear=True) is drawn")
    if members % chunk_members:
        raise ValueError(f"{members} members do not split into blocks of "
                         f"{chunk_members}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    lam = box_strength(xs, ys, zs, device)
    ramp = 2.0 * torch.linspace(0.0, 1.0, members, device=device) - 1.0
    for c0 in range(0, members, chunk_members):
        block = torch.randn((chunk_members, zs, ys, xs), generator=gen,
                            device=device)
        block.mul_(1.0 - lam).addcmul_(
            lam, ramp[c0:c0 + chunk_members, None, None, None])
        yield block
