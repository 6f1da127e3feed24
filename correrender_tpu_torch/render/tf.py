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
import xml.etree.ElementTree as ET

import numpy as np
import torch

from correrender_tpu_torch.diagrams import colormaps

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


def lut_lookup(lut: torch.Tensor, domain: torch.Tensor,
               scalar: torch.Tensor) -> torch.Tensor:
    """Linear LUT lookup with clamp-to-edge: ``(...,)`` scalars against a
    ``(2,)`` float32 ``domain`` tensor → ``(..., 4)`` RGBA. NaN scalars
    are read at bin 0 (their index is zeroed before the integer cast,
    whose NaN result differs between devices); callers mask them."""
    res = lut.shape[0]
    t = torch.clamp((scalar - domain[0]) / (domain[1] - domain[0]), 0.0,
                    1.0) * (res - 1)
    t = torch.nan_to_num(t, nan=0.0)
    i0 = torch.clamp(torch.floor(t).to(torch.long), 0, res - 2)
    frac = (t - i0.to(torch.float32))[..., None]
    return lut[i0] * (1.0 - frac) + lut[i0 + 1] * frac


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
        """Build from a named colormap and a piecewise-linear opacity
        ramp. ``name`` is one of the four built-ins above or any of the
        reference's 38 named diagram colormaps
        (``diagrams.colormaps.COLOR_MAP_NAMES``, e.g. ``"Cividis"``,
        ``"Cool to Warm"``), case-insensitively; an unknown name raises
        ``KeyError``."""
        if name in _COLORMAPS:
            points = _COLORMAPS[name]
        else:
            pts = colormaps.get_color_points(name)
            xs = np.linspace(0.0, 1.0, len(pts))
            points = list(zip(xs, pts))
        return cls.from_control_points(points, opacity_points, domain,
                                       resolution, device=device)

    @classmethod
    def constant_opacity(cls, name="coolwarm", domain=(0.0, 1.0), alpha=0.5,
                         resolution=256, device=None):
        """A named colormap at one opacity."""
        return cls.from_colormap(name, domain, ((0.0, alpha), (1.0, alpha)),
                                 resolution, device)

    @classmethod
    def from_control_points(
        cls,
        color_points,
        opacity_points,
        domain=(0.0, 1.0),
        resolution: int = 256,
        interpolate_linear_rgb: bool = False,
        device=None,
    ) -> "TransferFunction":
        """Build from piecewise-linear control points ``(pos, (r, g, b))``
        (sRGB-encoded) and ``(pos, alpha)``, positions in ``[0, 1]`` (the
        reference TF widget's serialized state). Colours interpolate in
        the stored sRGB values, or with ``interpolate_linear_rgb`` in
        linear RGB (the widget's default colour space); the LUT stays
        sRGB-encoded either way."""
        color_points = [(float(x), tuple(float(v) for v in c))
                        for x, c in color_points]
        opacity_points = [(float(x), float(a)) for x, a in opacity_points]
        if interpolate_linear_rgb:
            rgb = _linear_to_srgb(_sample_control_points(
                [(x, tuple(_srgb_to_linear(c))) for x, c in color_points],
                resolution))
        else:
            rgb = _sample_control_points(color_points, resolution)
        alpha = _sample_control_points(
            [(x, (a,)) for x, a in opacity_points], resolution
        )
        lut = np.concatenate([rgb, alpha], axis=-1).astype(np.float32)
        return cls(lut=torch.as_tensor(lut, device=device),
                   domain=tuple(float(d) for d in domain),
                   color_points=color_points, opacity_points=opacity_points)

    def __call__(self, scalar: torch.Tensor) -> torch.Tensor:
        """Map scalars to RGBA, shape ``scalar.shape + (4,)``; a NaN
        scalar maps to alpha 0 (NaN handling "ignore",
        DvrRenderer.hpp:69-71)."""
        domain = torch.tensor(self.domain, dtype=torch.float32,
                              device=scalar.device)
        rgba = lut_lookup(self.lut.to(scalar.device), domain, scalar)
        return torch.where(torch.isnan(scalar)[..., None], 0.0, rgba)

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


# -- the reference TF widget's XML interchange ----------------------------
#
# The reference stores each field's transfer function as sgl's XML
# control-point serialization inside its state files
# (MainAppState.cpp:171 serializeXmlString, :379 deserializeXmlString):
#
#   <TransferFunction colorspace="sRGB"
#                     interpolation_colorspace="Linear RGB">
#       <OpacityPoints><OpacityPoint position="0" opacity="1"/>...
#       <ColorPoints color_data="ushort">
#           <ColorPoint position="0" r="15163" g="19532" b="49344"/>...
#   </TransferFunction>
#
# Colours are sRGB-encoded and scaled by ``color_data`` (ushort 0..65535,
# ubyte 0..255, float 0..1); they interpolate in the declared colour space.


def _srgb_to_linear(c):
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92,
                    ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def _linear_to_srgb(c):
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * np.maximum(c, 0.0) ** (1.0 / 2.4)
                    - 0.055).astype(np.float32)


_COLOR_DATA_SCALE = {"ushort": 65535.0, "ubyte": 255.0, "float": 1.0}


def tf_from_xml_string(xml_str: str, domain=(0.0, 1.0),
                       resolution: int = 256,
                       device=None) -> TransferFunction:
    """Parse the reference TF widget's XML into a transfer function on
    ``device``. Honours ``color_data`` and ``interpolation_colorspace``
    ("Linear RGB" interpolates the decoded sRGB colours in linear space,
    as the widget does; "sRGB" the stored values)."""
    root = ET.fromstring(xml_str.replace("\x00", "").strip())
    if root.tag != "TransferFunction":
        raise ValueError(f"not a TransferFunction XML (root {root.tag!r})")
    interp = root.get("interpolation_colorspace", "Linear RGB")
    opacity_points = [(float(node.get("position")),
                       float(node.get("opacity")))
                      for node in root.iter("OpacityPoint")]
    scale = 65535.0
    colors_node = root.find("ColorPoints")
    if colors_node is not None:
        data_kind = colors_node.get("color_data", "ushort")
        if data_kind not in _COLOR_DATA_SCALE:
            raise ValueError(f"unsupported color_data {data_kind!r}")
        scale = _COLOR_DATA_SCALE[data_kind]
    color_points = [(float(node.get("position")),
                     (float(node.get("r")) / scale,
                      float(node.get("g")) / scale,
                      float(node.get("b")) / scale))
                    for node in root.iter("ColorPoint")]
    if not opacity_points:
        opacity_points = [(0.0, 0.0), (1.0, 1.0)]
    if not color_points:
        color_points = _COLORMAPS["coolwarm"]
    return TransferFunction.from_control_points(
        sorted(color_points), sorted(opacity_points), domain=tuple(domain),
        resolution=resolution,
        interpolate_linear_rgb=(interp == "Linear RGB"), device=device)


def _fmt(x: float) -> str:
    """Float → shortest exact decimal (a lossless round trip)."""
    return repr(float(x))


def tf_to_xml_string(tf: TransferFunction, num_points: int = 17) -> str:
    """Serialize a transfer function as the reference TF widget's XML.

    Writes the stored control points where the function has them
    (lossless); a LUT-only function is sampled at ``num_points`` uniform
    positions. Colours are ushort-scaled, as the widget writes them."""
    if tf.color_points is not None and tf.opacity_points is not None:
        color_points = tf.color_points
        opacity_points = tf.opacity_points
    else:
        lut = tf.lut.detach().cpu().numpy().astype(np.float32)
        pos = np.linspace(0.0, 1.0, num_points)
        idx = np.clip((pos * (lut.shape[0] - 1)).round().astype(int),
                      0, lut.shape[0] - 1)
        color_points = [(float(p), tuple(float(v) for v in lut[i, :3]))
                        for p, i in zip(pos, idx)]
        opacity_points = [(float(p), float(lut[i, 3]))
                          for p, i in zip(pos, idx)]
    lines = ['<TransferFunction colorspace="sRGB" '
             'interpolation_colorspace="Linear RGB">', "    <OpacityPoints>"]
    for p, a in opacity_points:
        lines.append(f'        <OpacityPoint position="{_fmt(p)}" '
                     f'opacity="{_fmt(a)}"/>')
    lines.append("    </OpacityPoints>")
    lines.append('    <ColorPoints color_data="ushort">')
    for p, rgb in color_points:
        r, g, b = (int(round(min(max(float(v), 0.0), 1.0) * 65535))
                   for v in rgb)
        lines.append(f'        <ColorPoint position="{_fmt(p)}" '
                     f'r="{r}" g="{g}" b="{b}"/>')
    lines.append("    </ColorPoints>")
    lines.append("</TransferFunction>")
    return "\n".join(lines) + "\n"
