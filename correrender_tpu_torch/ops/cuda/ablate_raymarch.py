"""Where B5's time goes: variants of ``raymarch_dvr_kernel``
(``csrc/raymarch.cu``) timed on the card.

    python3 -m correrender_tpu_torch.ops.cuda.ablate_raymarch [--parent DIR]

The inputs are the exact headline frame of ``chip_smoke.py``: the K1
Pearson field of the 250³ × 100 ``synth_box_stack`` (seed 0, reference
at (62, 62, 125)), config 1's camera and transfer function, 1920×1080,
voxel step 0.1 (q = 10), prepared as ``dvr_render_exact`` prepares it.
The variants are template instances that only this script launches,
through ``correrender_raymarch_dvr_probe`` in the shipped library:

- "8 x 4 tile" (each warp an 8 × 4 pixel tile, the shipped kernel) and
  "32 x 1 tile" (each warp a row of 32 pixels): the same march, whose
  images the script checks equal;
- "no TF search": the segment index is u·(K − 1) rounded down, as if
  the knots were evenly spaced (config 1's are: 0, 0.5 and 1), so the
  image stays the shipped one here and the saving is the search's (its
  4 FMAs stay);
- "one tap": the sample is one voxel instead of the eight-tap trilinear
  sample;
- "no expf": alpha = min(τ, 1) instead of 1 − exp(−τ).

The other two probes change the image, and so where rays stop, on
purpose: each variant's samples are counted in a separate run (the
count is not in the timed runs), and samples/s is that count over its
time. With
``--parent DIR`` (a checkout of an earlier commit) the script also
builds that commit's ``raymarch.cu`` on its own and times its
``correrender_raymarch_dvr`` on the same inputs with the hinge table
that commit takes, its image checked against the shipped kernel's at
``chip_smoke.py``'s B5 bar (1e-4); its samples/s uses the shipped
kernel's count. Prints one line per variant: the median of 5 CUDA-event
timings, the shipped kernel first and last, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.ablate_ksg_banded import median_ms
from correrender_tpu_torch.ops.cuda.ablate_spearman import card_line

# (label, tile width, probe); probe 0 is the shipped march.
VARIANTS = [("8 x 4 tile (shipped)", 8, 0), ("32 x 1 tile", 32, 0),
            ("no TF search", 8, 1), ("one tap", 8, 2), ("no expf", 8, 3)]
ATOL_PARENT = 1e-4  # chip_smoke.py: ATOL_RAYMARCH


def build_parent(root: Path):
    """The parent checkout's raymarch.cu, built alone; its library."""
    csrc = root / "correrender_tpu_torch" / "ops" / "cuda" / "csrc"
    out = _build._BUILD_DIR.parent / "ablate_raymarch" / "parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", str(out), str(csrc / "raymarch.cu")],
        check=True)
    lib = ctypes.CDLL(str(out))
    lib.correrender_raymarch_dvr.argtypes = _build._SIGNATURES[
        "correrender_raymarch_dvr"]
    lib.correrender_raymarch_dvr.restype = ctypes.c_int
    return lib


def exact_inputs(dev):
    """The prepared field, camera, TF, image size and plan of the exact
    headline frame."""
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
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
    cam, tf, size = config1_camera(), config1_transfer_function(dev), (1920,
                                                                       1080)
    plan = plan_raymarch(cam, field.shape, size)
    plan["q"] = _q_from_voxel_step(plan, 0.1)
    prep = ExactPrepared(field).get(plan["axis_world"], plan["flip"],
                                    plan["lane_axis"])
    return prep, cam, tf, size, plan


def main() -> None:
    from correrender_tpu_torch.ops.cuda import raymarch_kernel as rk

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
    prep, cam, tf, size, plan = exact_inputs(dev)
    fields, params, hinge_tfp, metric = rk._inputs(
        prep, cam, tf, size, plan, 100.0, "ignore", None, None)
    fields = fields.contiguous()
    knots, values, slopes = rk.tf_segments(tf)
    table = np.ascontiguousarray(np.concatenate([knots[None], values,
                                                 slopes]))
    width, height = size
    planes, sub, lane = prep.shape
    rgb = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty((height, width), dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    stream = _build.stream_of(alpha)

    def probe(tile, which, samples=None):
        return lambda: _build.check(lib.correrender_raymarch_dvr_probe(
            prep.data_ptr(), planes, sub, lane, fields.data_ptr(), width,
            height, params.ctypes.data, table.ctypes.data, len(knots),
            plan["q"], 0, 0, rgb.data_ptr(), alpha.data_ptr(), tile, which,
            samples, dev.index, stream), "raymarch_dvr_probe")

    def image():
        return torch.cat([rgb.reshape(-1), alpha.reshape(-1)]).clone()

    def counted(tile, which):
        count.zero_()
        probe(tile, which, count.data_ptr())()
        torch.cuda.synchronize()
        return int(count)

    shipped_img = torch.cat([t.reshape(-1) for t in rk.dvr_raymarch(
        prep, cam, tf, size, plan)])
    torch.cuda.synchronize()
    shipped_samples = counted(8, 0)
    print(f"[ablate B5 {card}] 250^3 K1 field, {width}x{height}, q "
          f"{plan['q']}, config 1's TF ({len(knots)} knots): the shipped "
          f"kernel takes {shipped_samples} samples "
          f"({shipped_samples / (width * height):.1f} per ray)")
    runs = [(name, probe(tile, which), tile, which)
            for name, tile, which in VARIANTS]
    if parent is not None:
        def parent_run():
            _build.check(parent.correrender_raymarch_dvr(
                prep.data_ptr(), planes, sub, lane, fields.data_ptr(), width,
                height, params.ctypes.data, hinge_tfp.ctypes.data,
                hinge_tfp.shape[1] - 1, plan["q"], 0, 0, rgb.data_ptr(),
                alpha.data_ptr(), dev.index, stream), "parent raymarch_dvr")
        runs.append(("parent's kernel", parent_run, None, None))
    runs.append(("8 x 4 tile (shipped)", probe(8, 0), 8, 0))
    for name, run, tile, which in runs:
        run()
        torch.cuda.synchronize()
        same = torch.equal(image(), shipped_img)
        if tile is not None and which == 0:
            assert same, name
        elif tile is None:
            err = float((image() - shipped_img).abs().max())
            assert err <= ATOL_PARENT, (name, err)
        ms = median_ms(run)
        samples = counted(tile, which) if tile is not None else (
            shipped_samples)
        print(f"[ablate B5 {card}] {name}: {ms:.3f} ms (median of 5), "
              f"image {'equal to' if same else 'unlike'} the shipped one, "
              f"{samples} samples, {samples / ms * 1e3:.4g} samples/s")
    ms = median_ms(lambda: rk.dvr_raymarch(prep, cam, tf, size, plan))
    print(f"[ablate B5 {card}] the wrapper dvr_raymarch (ray fields, the "
          f"shipped kernel): {ms:.3f} ms (median of 5)")


if __name__ == "__main__":
    main()
