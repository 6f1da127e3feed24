"""Whether what the timed path produced is correct.

Once the window has closed and the program's state is freed, the kept
outputs (a sample of the window's interactions drawn from the seed, and
its last) are held to the plain references of ``reference/``, found by
the mix's ``measure`` and the configuration's ``serve.renderer``:

* ``field_gap``: the largest |program − reference| of the correlation
  field. The set-up's first field (from which the Scene's default
  transfer function is taken) and the kept interactions' fields, in that
  order, are compared over every voxel, up to the cell's
  ``check.whole_fields`` of them (all where it is not set); the rest
  over ``check.voxels`` voxels drawn from the seed.
* ``frame_gap``: the largest, over the kept frames, of the mean
  |program − reference| of the premultiplied RGBA frame. The reference
  frame is drawn from the reference's whole field where there is one,
  else from the program's field, which ``field_gap`` holds on its
  sample. The default transfer function's domain is always the
  reference's whole first field's.

Each number has its limit in ``workloads/<cell>.json``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import spec, traffic
from benchmark.reference import dvr as ref_tf


def _reference(name: str):
    return spec.load_module("reference", name)


def references(cell):
    """(measure reference, frame reference or None) of a cell: raises
    before any set-up where the benchmark has no reference for what the
    cell serves, or the frame reference draws no such settings."""
    measure = _reference(cell.traffic["measure"])
    serve = cell.config["serve"]
    if "renderer" not in serve:
        return measure, None
    frame = _reference(serve.get("frame_reference", serve["renderer"]))
    unknown = set(serve.get("renderer_settings", {})) - set(frame.SETTINGS)
    if unknown:
        raise ValueError(f"the frame reference of {serve['renderer']!r} "
                         f"draws no {sorted(unknown)}")
    return measure, frame


def _max_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog − ref|; NaN in one and not the other counts infinite."""
    prog = prog.to(torch.float64).reshape(-1)
    ref = ref.to(torch.float64).reshape(-1)
    nan_p, nan_r = torch.isnan(prog), torch.isnan(ref)
    if bool((nan_p != nan_r).any()):
        return math.inf
    if bool(nan_p.all()):
        return 0.0
    return float((prog[~nan_p] - ref[~nan_r]).abs().max())


def premultiplied(frame: torch.Tensor) -> torch.Tensor:
    return torch.cat([frame[..., :3] * frame[..., 3:4], frame[..., 3:4]],
                     dim=-1)


def _frame_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    gap = (premultiplied(prog.float()) - premultiplied(ref.float())).abs()
    return float(torch.nan_to_num(gap, nan=math.inf).mean())


def _lut(mix: dict, first: torch.Tensor):
    """(LUT tensor, domain) of the frames: the mix's transfer function,
    or the Scene's default worked out from ``first``, the reference's
    whole first field."""
    tf = mix.get("transfer_function", "scene_default")
    if tf == "scene_default":
        field = first.float()
        finite = field[~torch.isnan(field)]
        lo, hi = (float(finite.min()), float(finite.max())) if \
            finite.numel() else (math.nan, math.nan)
        colormap, domain = "coolwarm", (lo, hi)
        opacity = ref_tf.default_opacity_points(lo, hi)
    else:
        colormap, domain = tf["colormap"], tuple(tf["domain"])
        opacity = tf["opacity_points"]
    lut = ref_tf.lut_from_points(colormap, opacity)
    return torch.as_tensor(lut, device=first.device), domain


def readings(cell, driver, kept: list, seed: int,
             frame_layout=torch.bfloat16) -> dict:
    """``{name: value}`` of the numbers compared. ``kept`` holds dicts
    ``{"point", "camera", "field", "frame"}``: the reference point and
    camera in effect and the outputs. With ``frame_layout`` other than
    bfloat16, the frames compared are the reference's own at that layout
    precision (a control of ``frame_gap``)."""
    measure, frame_ref = references(cell)
    mix, config, check = cell.traffic, cell.config, cell.settings["check"]
    grid_zyx = tuple(config["dataset"][k] for k in ("zs", "ys", "xs"))
    # The set-up's first field leads; each distinct point has one
    # reference, against which every field of that point is held.
    entries = [(tuple(k["point"]), k["field"]) for k in kept]
    if getattr(driver, "first_field", None) is not None:
        entries.insert(0, (tuple(driver.first_point), driver.first_field))
    points = list(dict.fromkeys(p for p, _ in entries))
    whole = points[:check.get("whole_fields", len(points))]
    rest = points[len(whole):]
    refs, idx = {}, None
    if whole:
        refs.update(zip(whole, measure.field(driver.inputs(), whole, mix)))
    if rest:
        voxels = math.prod(grid_zyx)
        gen = traffic.rng(seed, traffic.STREAM_CHECK + 1)
        idx = torch.as_tensor(np.sort(gen.choice(
            voxels, size=min(int(check["voxels"]), voxels),
            replace=False)), device=entries[0][1].device)
        refs.update(zip(rest, measure.field(driver.inputs(), rest, mix,
                                            voxels=idx)))
    gaps = [_max_gap(f if p in whole else f.reshape(-1)[idx], refs[p])
            for p, f in entries]
    out = {"field_gap": max(gaps)}
    frames = [k for k in kept if k.get("frame") is not None]
    if frames:
        lut, domain = _lut(mix, refs[points[0]])
        gaps = []
        for k in frames:
            p = tuple(k["point"])
            field = refs[p] if p in whole else k["field"]
            field = field.reshape(grid_zyx).to(torch.float32)
            ref = frame_ref.frame(field, k["camera"], lut, domain,
                                  config["serve"])
            prog = k["frame"] if frame_layout == torch.bfloat16 else \
                frame_ref.frame(field, k["camera"], lut, domain,
                                config["serve"], layout_dtype=frame_layout)
            gaps.append(_frame_gap(prog, ref))
            del ref, prog
        out["frame_gap"] = max(gaps)
    return out


def verdict(cell, values: dict) -> tuple[bool, dict]:
    """(correct, ``{name: {"value", "limit"}}``) against the cell's
    limits; a number that is NaN or over its limit is not correct."""
    limits = cell.settings["limits"]
    report = {name: {"value": values[name], "limit": limits[name]}
              for name in values}
    ok = all(not math.isnan(v["value"]) and v["value"] <= v["limit"]
             for v in report.values())
    missing = set(limits) - set(values)
    return ok and not missing, report
