"""Hand the state that defines a frame from numpy to the port.

Both packages compute the same frame from the same member stack,
transfer-function LUT and domain, and camera, and the same neural field
from the same network parameters. Tests build these once as numpy arrays
and plain values, and give them to the JAX package and, through these
functions, to the port.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.models.tree import tree_map
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.render.tf import TransferFunction


def stack_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """A ``(Z, Y, X, n)`` member-last numpy stack as a contiguous float32
    tensor on ``device``."""
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def transfer_function_from_arrays(lut: np.ndarray, domain, device=None,
                                  color_points=None,
                                  opacity_points=None) -> TransferFunction:
    """A transfer function from a ``(R, 4)`` straight-alpha LUT array and,
    optionally, the control points it was sampled from (a JAX
    ``TransferFunction``'s ``color_points`` / ``opacity_points``)."""
    lut = np.asarray(lut, np.float32)
    if lut.ndim != 2 or lut.shape[1] != 4:
        raise ValueError(f"lut has shape {lut.shape}, expected (R, 4)")
    if color_points is not None:
        color_points = [(float(x), tuple(float(v) for v in c))
                        for x, c in color_points]
    if opacity_points is not None:
        opacity_points = [(float(x), float(a)) for x, a in opacity_points]
    return TransferFunction(lut=torch.tensor(lut, device=device),
                            domain=tuple(float(d) for d in domain),
                            color_points=color_points,
                            opacity_points=opacity_points)


def camera_from_fields(position, look_at_point, up, fovy, z_near,
                       z_far) -> Camera:
    """A camera from the fields the JAX package's ``Camera`` holds."""
    return Camera(
        position=tuple(float(c) for c in position),
        look_at_point=tuple(float(c) for c in look_at_point),
        up=tuple(float(c) for c in up),
        fovy=float(fovy),
        z_near=float(z_near),
        z_far=float(z_far),
    )


def srn_params_from_jax(params, device=None):
    """The port's parameter tree from a JAX SRN's (or MINE's) parameter
    pytree given as numpy arrays: the same nesting of dicts and lists,
    each array a tensor of its dtype on ``device``. The layouts are the
    same (``w`` as ``(in, out)``), so nothing is transposed."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    params)
