"""Transfer functions: scalar → RGBA through a LUT.

Counterpart of ``correrender_tpu/render/tf.py``. A transfer function is
a ``(resolution, 4)`` float32 LUT tensor (straight alpha) plus a host
value domain; lookup is linear interpolation with clamp-to-edge. A
transfer function built from control points keeps them: the exact
marcher evaluates the piecewise-linear function from its hinges
(``ops/cuda/raymarch_kernel.py::tf_hinges``), not from the LUT.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

# Built-in colormaps as control points (positions in [0, 1], rgb); the
# same values as the JAX package's.
_COLORMAPS = {
    "gray": [(0.0, (0.0, 0.0, 0.0)), (1.0, (1.0, 1.0, 1.0))],
    # Default of the reference's TF widget: blue→white→red diverging.
    "coolwarm": [
        (0.0, (0.231, 0.299, 0.754)),
        (0.5, (0.865, 0.865, 0.865)),
        (1.0, (0.706, 0.016, 0.150)),
    ],
    "viridis": [
        (0.0, (0.267, 0.005, 0.329)),
        (0.25, (0.229, 0.322, 0.546)),
        (0.5, (0.127, 0.566, 0.551)),
        (0.75, (0.369, 0.789, 0.383)),
        (1.0, (0.993, 0.906, 0.144)),
    ],
    "heatmap": [
        (0.0, (0.0, 0.0, 0.0)),
        (0.35, (0.85, 0.0, 0.0)),
        (0.85, (1.0, 1.0, 0.0)),
        (1.0, (1.0, 1.0, 1.0)),
    ],
}


#: Source of :attr:`TransferFunction.uid`.
_TF_UID = itertools.count()


def default_opacity_points(lo: float, hi: float):
    """The default opacity curve for a field's range: a sign-spanning
    domain (a correlation coefficient) gets a zero-opacity notch at its
    centre, a one-signed domain a plain ramp."""
    return (((0.0, 0.7), (0.5, 0.0), (1.0, 0.7))
            if lo < 0 < hi else ((0.0, 0.0), (1.0, 0.8)))


def _sample_control_points(points, resolution):
    xs = np.array([p[0] for p in points], np.float32)
    vals = np.array([p[1] for p in points], np.float32)
    t = np.linspace(0.0, 1.0, resolution, dtype=np.float32)
    return np.stack(
        [np.interp(t, xs, vals[:, c]) for c in range(vals.shape[1])], axis=-1
    )


@dataclasses.dataclass
class TransferFunction:
    """LUT-based transfer function over a scalar domain.

    Attributes:
      lut: ``(resolution, 4)`` float32 RGBA, straight alpha.
      domain: host ``(vmin, vmax)`` scalar range mapped onto the LUT.
      uid: a monotonic instance id, the invalidation token of layouts
        classified through this function (``id()`` may be reused once an
        object is freed).
      color_points, opacity_points: the source control points
        ``[(pos, (r, g, b)), ...]`` and ``[(pos, alpha), ...]`` when the
        LUT was built from them; ``None`` for a LUT-only function.
    """

    lut: torch.Tensor
    domain: tuple = (0.0, 1.0)
    uid: int = dataclasses.field(default_factory=lambda: next(_TF_UID),
                                 compare=False)
    color_points: list | None = dataclasses.field(default=None,
                                                  compare=False)
    opacity_points: list | None = dataclasses.field(default=None,
                                                    compare=False)

    @classmethod
    def from_colormap(
        cls,
        name: str = "coolwarm",
        domain=(0.0, 1.0),
        opacity_points=((0.0, 0.0), (1.0, 1.0)),
        resolution: int = 256,
        device=None,
    ) -> "TransferFunction":
        """Build from a built-in colormap and a piecewise-linear opacity
        ramp. Only the four built-ins exist so far."""
        if name not in _COLORMAPS:
            raise NotImplementedError(
                f"colormap {name!r}: the diagram colormaps "
                "(diagrams.colormaps) are not ported yet (ROADMAP A.4)"
            )
        return cls.from_control_points(_COLORMAPS[name], opacity_points,
                                       domain, resolution, device)

    @classmethod
    def from_control_points(
        cls,
        color_points,
        opacity_points,
        domain=(0.0, 1.0),
        resolution: int = 256,
        device=None,
    ) -> "TransferFunction":
        """Build from piecewise-linear control points ``(pos, (r, g, b))``
        and ``(pos, alpha)``, positions in ``[0, 1]``, interpolated in the
        stored (sRGB) values."""
        color_points = [(float(x), tuple(float(v) for v in c))
                        for x, c in color_points]
        opacity_points = [(float(x), float(a)) for x, a in opacity_points]
        rgb = _sample_control_points(color_points, resolution)
        alpha = _sample_control_points(
            [(x, (a,)) for x, a in opacity_points], resolution
        )
        lut = np.concatenate([rgb, alpha], axis=-1).astype(np.float32)
        return cls(lut=torch.as_tensor(lut, device=device),
                   domain=tuple(float(d) for d in domain),
                   color_points=color_points, opacity_points=opacity_points)

    def to_dict(self) -> dict:
        """JSON state: the domain, the full LUT (a lossless round trip)
        and the control points where known."""
        out = {
            "domain": list(self.domain),
            "lut": self.lut.detach().cpu().numpy().tolist(),
        }
        if self.color_points is not None:
            out["color_points"] = [[p, *rgb] for p, rgb in self.color_points]
        if self.opacity_points is not None:
            out["opacity_points"] = [[p, a] for p, a in self.opacity_points]
        return out

    @classmethod
    def from_dict(cls, d: dict, device=None) -> "TransferFunction":
        """The inverse of :meth:`to_dict`, with the LUT on ``device``; a
        state with control points but no LUT samples them."""
        domain = tuple(float(v) for v in d.get("domain", (0.0, 1.0)))
        if "lut" not in d:
            return cls.from_control_points(
                [(p[0], tuple(p[1:4])) for p in d["color_points"]],
                [(p[0], p[1]) for p in d["opacity_points"]],
                domain=domain, device=device)
        color_points = opacity_points = None
        if "color_points" in d and "opacity_points" in d:
            color_points = [(float(p[0]), tuple(float(v) for v in p[1:4]))
                            for p in d["color_points"]]
            opacity_points = [(float(p[0]), float(p[1]))
                              for p in d["opacity_points"]]
        return cls(lut=torch.as_tensor(np.asarray(d["lut"], np.float32),
                                       device=device),
                   domain=domain, color_points=color_points,
                   opacity_points=opacity_points)
