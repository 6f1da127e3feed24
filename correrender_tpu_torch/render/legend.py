"""Colour-legend overlay for rendered views.

Counterpart of ``correrender_tpu/render/legend.py`` (the reference's
per-field colour legend, sgl's widget): a vertical transfer-function bar
with min/mid/max labels in a built-in 5x7 bitmap font, over a dimmed
panel. :func:`color_legend_overlay` is a copy of the JAX package's numpy
function. :func:`legend_patch` rasterizes the same legend into the
panel's rectangle alone, and :func:`blend_legend` lays it over a frame
on its device, so a frame does not travel to the host and back.
"""

from __future__ import annotations

import numpy as np
import torch

# 5x7 bitmap glyphs for numeric labels (rows top→bottom, 5-bit masks).
_GLYPHS = {
    "0": (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E),
    "1": (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "2": (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F),
    "3": (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    "4": (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02),
    "5": (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    "6": (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E),
    "7": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    "8": (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E),
    "9": (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
    "-": (0x00, 0x00, 0x00, 0x1F, 0x00, 0x00, 0x00),
    "+": (0x00, 0x04, 0x04, 0x1F, 0x04, 0x04, 0x00),
    ".": (0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C),
    "e": (0x00, 0x00, 0x0E, 0x11, 0x1F, 0x10, 0x0E),
    " ": (0x00,) * 7,
}

#: The panel's dimming: rgb scaled, alpha raised to at least this.
_PANEL_RGB, _PANEL_ALPHA = 0.35, 0.65


def _draw_text(img: np.ndarray, x: int, y: int, text: str,
               color=(1.0, 1.0, 1.0)):
    """Blit 5x7 glyphs at (x, y) top-left; clips at the image bounds."""
    h, w = img.shape[:2]
    for ch in text:
        glyph = _GLYPHS.get(ch)
        if glyph is None:
            glyph = _GLYPHS[" "]
        for r, rowmask in enumerate(glyph):
            yy = y + r
            if not 0 <= yy < h:
                continue
            for c in range(5):
                if rowmask & (1 << (4 - c)):
                    xx = x + c
                    if 0 <= xx < w:
                        img[yy, xx, :3] = color
                        img[yy, xx, 3] = 1.0
        x += 6
    return img


def _fmt(v: float) -> str:
    """Compact numeric label using only the built-in glyphs."""
    if v == 0:
        return "0"
    a = abs(v)
    if a >= 1e4 or a < 1e-2:
        s = f"{v:.1e}"
        mant, exp = s.split("e")  # '1.0e-03' → '1.0e-3'
        return f"{mant}e{int(exp)}"
    if a >= 100:
        return f"{v:.0f}"
    return f"{v:.2f}".rstrip("0").rstrip(".")


def _layout(h, w, domain, position, bar_width, margin):
    """The legend's bar origin ``(x0, y0)``, bar height, labels (with
    their rows below the bar's top) and width in a ``h × w`` frame."""
    lo, hi = (float(v) for v in domain)
    bar_h = max(int(h * 0.5), 24)
    y0 = (h - bar_h) // 2
    labels = [(_fmt(hi), 0), (_fmt((lo + hi) / 2), bar_h // 2),
              (_fmt(lo), bar_h - 7)]
    label_w = 6 * max(len(t) for t, _ in labels) + 2
    total_w = bar_width + 4 + label_w
    x0 = w - margin - total_w if position == "right" else margin
    return x0, y0, bar_h, labels, total_w


def _draw_bar(img, lut, x0, y0, bar_h, bar_width, labels):
    """The gradient bar (row 0 = the domain's maximum), its 1 px frame
    and the labels, drawn into ``img`` at bar origin ``(x0, y0)``."""
    t = 1.0 - (np.arange(bar_h) + 0.5) / bar_h
    idx = np.clip((t * (len(lut) - 1)).astype(int), 0, len(lut) - 1)
    img[y0:y0 + bar_h, x0:x0 + bar_width, :3] = lut[idx, :3][:, None, :]
    img[y0:y0 + bar_h, x0:x0 + bar_width, 3] = 1.0
    img[y0, x0:x0 + bar_width, :3] = 1.0
    img[y0 + bar_h - 1, x0:x0 + bar_width, :3] = 1.0
    img[y0:y0 + bar_h, x0, :3] = 1.0
    img[y0:y0 + bar_h, x0 + bar_width - 1, :3] = 1.0
    for text, dy in labels:
        _draw_text(img, x0 + bar_width + 4, y0 + dy, text)


def _panel_bounds(h, w, x0, y0, bar_h, total_w):
    """The dimmed panel's rows and columns ``(by0, by1, bx0, bx1)``."""
    return (max(y0 - 5, 0), min(y0 + bar_h + 5, h), max(x0 - 3, 0),
            min(x0 + total_w + 3, w))


def color_legend_overlay(image: np.ndarray, transfer_function,
                         position: str = "right", bar_width: int = 12,
                         margin: int = 8) -> np.ndarray:
    """Rasterize ``transfer_function``'s legend into a copy of the host
    ``(H, W, 4)`` float32 ``image``: a vertical gradient bar (the domain's
    maximum at the top) over a semi-transparent panel, with min/mid/max
    labels."""
    img = np.array(image, np.float32, copy=True)
    h, w = img.shape[:2]
    lut = transfer_function.lut.detach().cpu().numpy()
    x0, y0, bar_h, labels, total_w = _layout(
        h, w, transfer_function.domain, position, bar_width, margin)
    by0, by1, bx0, bx1 = _panel_bounds(h, w, x0, y0, bar_h, total_w)
    panel = img[by0:by1, bx0:bx1]
    panel[..., :3] *= _PANEL_RGB
    panel[..., 3] = np.maximum(panel[..., 3], _PANEL_ALPHA)
    _draw_bar(img, lut, x0, y0, bar_h, bar_width, labels)
    return img


def legend_patch(image_size, transfer_function, position: str = "right",
                 bar_width: int = 12, margin: int = 8):
    """The legend of :func:`color_legend_overlay` over a ``(W, H)`` frame
    as ``(by0, bx0, patch)``: the panel's rectangle, NaN where the panel
    only dims the frame and the drawn RGBA elsewhere. None when the bar
    does not start inside the frame (a frame under about 60 × 24 px),
    where the host function's negative indices wrap around the frame."""
    w, h = image_size
    x0, y0, bar_h, labels, total_w = _layout(
        h, w, transfer_function.domain, position, bar_width, margin)
    if x0 < 0 or y0 < 0:
        return None
    by0, by1, bx0, bx1 = _panel_bounds(h, w, x0, y0, bar_h, total_w)
    patch = np.full((by1 - by0, bx1 - bx0, 4), np.nan, np.float32)
    # Inside the panel the bar and the labels clip where the frame does.
    _draw_bar(patch, transfer_function.lut.detach().cpu().numpy(),
              x0 - bx0, y0 - by0, bar_h, bar_width, labels)
    return by0, bx0, patch


def blend_legend(image: torch.Tensor, patch) -> torch.Tensor:
    """Lay a :func:`legend_patch` over the ``(H, W, 4)`` frame on its
    device: the panel dims the frame and the drawn pixels replace it, as
    :func:`color_legend_overlay` does. Returns a new frame."""
    by0, bx0, drawn = patch
    drawn = torch.as_tensor(drawn, device=image.device)
    ph, pw = drawn.shape[:2]
    region = image[by0:by0 + ph, bx0:bx0 + pw]
    dimmed = torch.cat([region[..., :3] * _PANEL_RGB,
                        torch.clamp_min(region[..., 3:], _PANEL_ALPHA)],
                       dim=-1)
    out = image.clone()
    out[by0:by0 + ph, bx0:bx0 + pw] = torch.where(torch.isnan(drawn),
                                                  dimmed, drawn)
    return out
