"""Where B6's time goes: variants of ``raymarch_iso_kernel``
(``csrc/raymarch.cu``) timed on the card.

    python3 -m correrender_tpu_torch.ops.cuda.ablate_iso [--parent DIR]

Two inputs:

- the headline iso frame of ``chip_smoke.py``: the K1 Pearson field of
  the 250³ × 100 ``synth_box_stack`` (seed 0, reference at
  (62, 62, 125)), config 1's camera, 1920×1080, voxel step 0.25 (q = 4),
  iso value 0.5, 8 bisection steps, prepared as ``iso_render_exact``
  prepares it;
- ``chip_smoke.py``'s B6 checks at 64³ and 512×288: a smoothed normal
  volume (seed 5) with a NaN voxel, iso value 0.05, q = 4, 8 bisection
  steps, the cameras "-z" (0.05, 0.08, 0.9) and "+x" (-0.9, 0.08, 0.05).

The variants are template instances that only this script launches,
through ``correrender_raymarch_iso_probe`` in the shipped library, each
one switch away from the shipped kernel (8 × 4 warp tiles, the march
loading its eight taps at every sample, refinement inline, the rays set
up in the kernel):

- "32 x 1 tile": each warp a row of 32 pixels (the first design's);
- "tap cache in the march": a ray keeps its eight taps while its
  sub-steps stay in one cell of the slab (``IsoTaps``; the bisection
  keeps them in every variant);
- "refinement compacted": the block queues its found rays in shared
  memory and its threads refine them in turn, where the shipped kernel
  refines a found ray at once while its warp's other lanes wait;
- "fields from torch": the kernel reads the five ray fields that the
  plain version's ``iso_ray_fields`` computes (about 80 torch launches);
  timed alone and with that function;
- "six blocks an SM": a launch bound that caps the registers at 40;
- "one tap": each sample reads one voxel of each plane instead of four
  (the answer changes: a probe of the loads' cost).

Every variant but "one tap" must give the shipped kernel's outputs bit
for bit, which the script checks. The samples each variant took are counted in a
separate run (not timed), with the march's SIMT efficiency: the
sub-steps the rays visited over the lane slots their warps spent (32 ×
the most any lane of the warp visited). With ``--parent DIR`` (a checkout of an earlier
commit) the script also builds that commit's ``raymarch.cu`` on its own
and times its ``correrender_raymarch_iso`` (the signature it had before
B6 set up its own rays) on ray fields from ``_ray_fields``, the torch
formula that B5 still uses; its fields differ from B6's in rounding, so
the script prints how many rays' found flags differ and the largest
|Δt| elsewhere. Prints one line per variant and input: the median of 11
CUDA-event timings, the shipped kernel first and last, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.ablate_spearman import card_line

# (label, tile width, cache, compact, setup, probe); the shipped switches
# are kRayTileWidth, kIsoMarchCache and kIsoCompact in csrc/raymarch.cu.
SHIPPED = ("shipped", 8, 0, 0, 1, 0)
FIELDS_FROM_TORCH = ("fields from torch", 8, 0, 0, 0, 0)
VARIANTS = [
    ("32 x 1 tile", 32, 0, 0, 1, 0),
    ("tap cache in the march", 8, 1, 0, 1, 0),
    ("refinement compacted", 8, 0, 1, 1, 0),
    FIELDS_FROM_TORCH,
    ("six blocks an SM", 8, 0, 0, 1, 2),
    ("one tap", 8, 0, 0, 1, 1),
]
ONE_TAP = 1  # the probe whose answer differs
REPS = 11
PARENT_SIGNATURE = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p]


def median_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_parent(root: Path):
    """The parent checkout's raymarch.cu, built alone; its library."""
    csrc = root / "correrender_tpu_torch" / "ops" / "cuda" / "csrc"
    out = _build._BUILD_DIR.parent / "ablate_iso" / "parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", str(out), str(csrc / "raymarch.cu")],
        check=True)
    lib = ctypes.CDLL(str(out))
    lib.correrender_raymarch_iso.argtypes = PARENT_SIGNATURE
    lib.correrender_raymarch_iso.restype = ctypes.c_int
    return lib


def headline_input(dev):
    """(label, prepared field, camera, iso value, image size, plan) of
    the headline iso frame."""
    from correrender_tpu_torch.app.baseline_configs import config1_camera
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.ops.cuda.raymarch_kernel import plan_raymarch
    from correrender_tpu_torch.render.pipeline import reference_series
    from correrender_tpu_torch.render.raymarch_exact import (
        ExactPrepared, _q_from_voxel_step)
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    gen = torch.Generator(device=dev).manual_seed(0)
    stack = synth_box_stack(250, 250, 250, 100, gen, dev)
    field = correlate_field(stack, reference_series(stack, (62, 62, 125)))
    del stack
    cam, size = config1_camera(), (1920, 1080)
    plan = plan_raymarch(cam, field.shape, size)
    plan["q"] = _q_from_voxel_step(plan, 0.25)
    prep = ExactPrepared(field).get(plan["axis_world"], plan["flip"],
                                    plan["lane_axis"])
    return ("250^3 K1 field, 1920x1080", prep, cam, 0.5, size, plan)


def small_inputs(dev):
    """chip_smoke.py's 64³, 512×288 B6 cases "-z" and "+x"."""
    from correrender_tpu_torch.ops.cuda.raymarch_kernel import (
        plan_raymarch, prepare_raymarch_volume)
    from correrender_tpu_torch.render.camera import Camera

    gen = torch.Generator(device=dev).manual_seed(5)
    n = 64
    vol = torch.randn((n, n, n), generator=gen, device=dev)
    for ax in range(3):
        vol = (vol + vol.roll(1, ax) + vol.roll(-1, ax)) / 3
    vol[n // 2, n // 2 - 2, n // 2 + 2] = float("nan")
    size = (512, 288)
    out = []
    for name, pos in (("-z", (0.05, 0.08, 0.9)), ("+x", (-0.9, 0.08, 0.05))):
        cam = Camera(position=pos)
        plan = plan_raymarch(cam, vol.shape, size, q=4)
        prep = prepare_raymarch_volume(vol, plan["axis_world"], plan["flip"],
                                       plan["lane_axis"])
        out.append((f"64^3 {name}, 512x288", prep, cam, 0.05, size, plan))
    return out


def ablate(lib, parent, case, card: str, dev) -> None:
    from correrender_tpu_torch.ops.cuda import raymarch_kernel as rk

    label, prep, cam, iso, size, plan = case
    refine = 8
    width, height = size
    planes, sub, lane = prep.shape
    params = rk._iso_params(plan, cam, iso, size)
    fields = torch.stack(rk.iso_ray_fields(cam, size, plan, dev)[:5])
    out = torch.empty((5, height, width), dtype=torch.float32, device=dev)
    dirs = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    count = torch.zeros(3, dtype=torch.int64, device=dev)
    stream = _build.stream_of(out)

    def probe(tile, cache, compact, setup, which, samples=None):
        return lambda: _build.check(lib.correrender_raymarch_iso_probe(
            prep.data_ptr(), planes, sub, lane, fields.data_ptr(), width,
            height, params.ctypes.data, plan["axis_world"], plan["sub_axis"],
            plan["lane_axis"], plan["q"], refine, out.data_ptr(),
            dirs.data_ptr(), tile, cache, compact, setup, which, samples,
            dev.index, stream), "raymarch_iso_probe")

    def counted(*switches):
        """(samples, the march's sub-steps visited, their warps' lane
        slots) of one run."""
        count.zero_()
        probe(*switches, samples=count.data_ptr())()
        torch.cuda.synchronize()
        return tuple(int(c) for c in count)

    probe(*SHIPPED[1:])()
    torch.cuda.synchronize()
    shipped_out = out.clone()
    wrapped = rk.iso_raymarch(prep, cam, iso, size, plan, refine_steps=refine)
    torch.cuda.synchronize()
    assert torch.equal(wrapped[0], shipped_out[0] > 0.5), label
    assert all(torch.equal(w, o) for w, o in zip(wrapped[1:5],
                                                 shipped_out[1:])), label
    shipped_counts = counted(*SHIPPED[1:])
    shipped_samples = shipped_counts[0]
    pixels = width * height
    print(f"[ablate B6 {card}] {label}, q {plan['q']}, iso {iso}, refine "
          f"{refine}: {100 * float((shipped_out[0] > 0.5).float().mean()):.2f}"
          f"% of the rays hit; the shipped kernel takes {shipped_samples} "
          f"samples ({shipped_samples / pixels:.1f} per ray)")
    runs = [(name, probe(*switches), switches)
            for name, *switches in [SHIPPED] + VARIANTS]
    if parent is not None:
        old_fields = rk._ray_fields(cam, size, plan, dev).contiguous()
        old_params = np.ascontiguousarray(params[:11])

        def parent_run():
            _build.check(parent.correrender_raymarch_iso(
                prep.data_ptr(), planes, sub, lane, old_fields.data_ptr(),
                width, height, old_params.ctypes.data, plan["q"], refine,
                out.data_ptr(), dev.index, stream), "parent raymarch_iso")
        runs.append(("parent's kernel (its torch fields apart)", parent_run,
                     None))
    runs.append(("shipped", probe(*SHIPPED[1:]), SHIPPED[1:]))
    for name, run, switches in runs:
        out.zero_()
        run()
        torch.cuda.synchronize()
        if switches is not None:
            same = torch.equal(out, shipped_out)
            assert same or switches[-1] == ONE_TAP, (label, name)
            samples, visited, slots = counted(*switches)
            note = (f"outputs {'equal to' if same else 'unlike'} the shipped"
                    f" kernel's, march SIMT efficiency "
                    f"{visited / max(slots, 1):.3f} ({visited} sub-steps in "
                    f"{slots} lane slots)")
        else:
            found, want = out[0] > 0.5, shipped_out[0] > 0.5
            both = found & want
            dt = float((out[1] - shipped_out[1])[both].abs().max()) if bool(
                both.any()) else 0.0
            note = (f"{int((found != want).sum())} rays' found flags differ "
                    f"from the shipped kernel's, max|dt| {dt:.3e} elsewhere")
            samples = shipped_samples
        ms = median_ms(run)
        print(f"[ablate B6 {card}] {label}: {name}: {ms:.4f} ms (median of "
              f"{REPS}), {note}, {samples} samples, "
              f"{samples / ms * 1e3:.4g} samples/s")
    torch_fields = median_ms(lambda: rk.iso_ray_fields(cam, size, plan, dev))
    setup0 = probe(*FIELDS_FROM_TORCH[1:])
    both_ms = median_ms(lambda: (rk.iso_ray_fields(cam, size, plan, dev),
                                 setup0()))
    old_ms = median_ms(lambda: rk._ray_fields(cam, size, plan, dev))
    wrapper_ms = median_ms(lambda: rk.iso_raymarch(prep, cam, iso, size, plan,
                                                   refine_steps=refine))
    print(f"[ablate B6 {card}] {label}: torch iso_ray_fields {torch_fields:.4f}"
          f" ms, with the fields-from-torch kernel {both_ms:.4f} ms; the "
          f"parent's torch _ray_fields {old_ms:.4f} ms; the wrapper "
          f"iso_raymarch (the shipped kernel) {wrapper_ms:.4f} ms (medians "
          f"of {REPS})")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="checkout of an earlier commit to time too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the ablation runs on the card")
    card = card_line()
    dev = torch.device("cuda", 0)
    lib = _build.library()
    parent = build_parent(args.parent) if args.parent else None
    for case in [headline_input(dev)] + small_inputs(dev):
        ablate(lib, parent, case, card, dev)


if __name__ == "__main__":
    main()
