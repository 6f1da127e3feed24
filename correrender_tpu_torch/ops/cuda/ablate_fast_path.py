"""Where K1's and K3's time goes: variants of ``csrc/pearson.cu`` and
``csrc/shearwarp.cu`` timed on the card.

    python3 -m correrender_tpu_torch.ops.cuda.ablate_fast_path [--parent DIR]

The variants are template instances that only this script and
``chip_smoke.py`` launch, through ``correrender_pearson_probe`` and
``correrender_shearwarp_composite_probe`` in the shipped library.

K1 runs on two shapes: the 250³ × 100 headline stack of
``chip_smoke.py`` (``synth_box_stack``, seed 0, reference at
(62, 62, 125)) and 48³ × 1000 independent normal series (seed 3,
reference at the centre). Its variants: lanes a voxel (4, 8, 16, 32),
ring stages (2, 3, 4), tiles of about 32 or 64 KB, and the direct
regime (one warp a voxel straight from device memory, the first
design made persistent). Each field is checked against the shipped kernel's
(within ``chip_smoke.py``'s K1 bar, 2e-5; equal where only the stages or
the tile differ).

K3 runs on the 1920×1080 headline frame's composite inputs (the same
stack's K1 field, config 1's camera and transfer function, intermediate
scale 0.75, K2's slices), without kstop and with a kstop ramp that stops
the rays from a quarter to three quarters of the slices. Its variants
(probe numbers of the C entry): 1, the taps computed inline for every
sample, one value rounded at a time, q fused, one pixel a thread: the
first kernel's arithmetic; 2, the tables with q fused (its image must
equal probe 1's); 3, unpacked rounding; 4, one pixel a thread; 5, four
pixels a thread; 6, a warp's exit once every lane's α is exactly 1.
Probes 3-6 must give the shipped image to the bit. A ``torch.profiler``
run splits the shipped call into its tap pre-pass and its composite.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. ``git
archive <commit> | tar -x -C build/parent``) the script also builds that
commit's ``pearson.cu`` and ``shearwarp.cu`` on their own and times its
``correrender_pearson`` (with the Σx, Σx² its wrapper passed) and
``correrender_shearwarp_composite`` on the same inputs, with the
signatures those entries had before this design; its K3 image is
compared with
probe 1's. Prints one line per variant: the median of 5 CUDA-event
timings, the shipped kernel first and last, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.ablate_ksg_banded import median_ms
from correrender_tpu_torch.ops.cuda.ablate_spearman import card_line

ATOL_PEARSON = 2e-5  # chip_smoke.py
HBM_BYTES_PER_S = 3.35e12
# (label, lanes, stages, tile bytes) per member count; lanes 0 is the
# direct regime.
K1_VARIANTS = {
    100: [("4 lanes, 3 stages, 32 KB tiles (shipped)", 4, 3, 32768),
          ("2 stages", 4, 2, 32768), ("4 stages", 4, 4, 32768),
          ("64 KB tiles", 4, 3, 65536), ("8 lanes", 8, 3, 32768),
          ("16 lanes", 16, 3, 32768), ("32 lanes", 32, 3, 32768),
          ("direct: a warp a voxel from device memory", 0, 0, 0)],
    1000: [("32 lanes, 3 stages, 32 KB tiles (shipped)", 32, 3, 32768),
           ("2 stages", 32, 2, 32768), ("4 stages", 32, 4, 32768),
           ("16 lanes", 16, 3, 32768),
           ("direct: a warp a voxel from device memory", 0, 0, 0)],
}
K3_VARIANTS = [
    ("tables, packed rounding, 2 pixels a thread (shipped)", 0),
    ("inline taps, unpacked, 1 pixel, q fused (the first kernel)", 1),
    ("tables with q fused", 2), ("unpacked rounding", 3),
    ("1 pixel a thread", 4), ("4 pixels a thread", 5),
    ("exit once every alpha is 1", 6),
]
K3_EQUAL_TO_SHIPPED = (3, 4, 5, 6)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# The entries' C signatures before this design (pearson: series, ref,
# stats, out, v, n; the composite without its tap scratch).
PARENT_SIGNATURES = {
    "correrender_pearson": [_P, _P, _P, _P, _L, _I, _I, _P],
    "correrender_shearwarp_composite": [
        _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
        _F, _F, _F, _F, _P, _P, _I, _P,
    ],
}


def build_parent(root: Path):
    """The parent checkout's pearson.cu and shearwarp.cu, built alone
    into one library."""
    csrc = root / "correrender_tpu_torch" / "ops" / "cuda" / "csrc"
    out = _build._BUILD_DIR.parent / "ablate_fast_path" / "parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-I", str(csrc), "-o", str(out),
         str(csrc / "pearson.cu"), str(csrc / "shearwarp.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in PARENT_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def k1_shapes(dev):
    """(label, (V, n) series, (n,) reference) of the two Pearson fields."""
    from correrender_tpu_torch.render.pipeline import reference_series
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    gen = torch.Generator(device=dev).manual_seed(0)
    stack = synth_box_stack(250, 250, 250, 100, gen, dev)
    yield ("250^3 x 100", stack.reshape(-1, 100),
           reference_series(stack, (62, 62, 125)))
    del stack
    gen = torch.Generator(device=dev).manual_seed(3)
    stack = torch.randn((48, 48, 48, 1000), generator=gen, device=dev)
    yield "48^3 x 1000", stack.reshape(-1, 1000), stack[24, 24, 24].clone()


def ablate_k1(lib, parent, card: str, dev) -> None:
    from correrender_tpu_torch.ops.cuda.pearson_kernel import pearson_cuda

    for label, series, ref in k1_shapes(dev):
        v, n = series.shape
        out = torch.empty(v, dtype=torch.float32, device=dev)
        stream = _build.stream_of(series)
        bound_ms = (4 * v * n + 4 * v + 4 * n) / HBM_BYTES_PER_S * 1e3

        def probe(lanes, stages, tile):
            return lambda: _build.check(lib.correrender_pearson_probe(
                series.data_ptr(), ref.data_ptr(), out.data_ptr(), v, n,
                lanes, stages, tile, dev.index, stream), "pearson_probe")

        variants = K1_VARIANTS[n]
        shipped_lanes = variants[0][1]
        runs = [(name, probe(lanes, stages, tile), lanes)
                for name, lanes, stages, tile in variants]
        if parent is not None:
            stats = torch.stack([ref.sum(), (ref * ref).sum()])

            def parent_run():
                _build.check(parent.correrender_pearson(
                    series.data_ptr(), ref.data_ptr(), stats.data_ptr(),
                    out.data_ptr(), v, n, dev.index, stream),
                    "parent pearson")
            runs.append(("the parent's kernel (Σx, Σx² given)", parent_run,
                         None))
        runs.append((variants[0][0], runs[0][1], shipped_lanes))
        shipped = pearson_cuda(series, ref)
        torch.cuda.synchronize()
        print(f"[ablate K1 {card}] {label}: {v} voxels, bound {bound_ms:.3f} "
              f"ms (one read of {4 * v * n / 1e9:.3f} GB at 3.35 TB/s)")
        for name, run, lanes in runs:
            run()
            torch.cuda.synchronize()
            err = float(torch.nan_to_num(out - shipped, nan=0.0).abs().max())
            assert torch.equal(torch.isnan(out), torch.isnan(shipped)), name
            assert err <= ATOL_PEARSON, (name, err)
            same = lanes == shipped_lanes
            assert err == 0.0 or not same, (name, err)
            ms = median_ms(run)
            print(f"[ablate K1 {card}] {label} {name}: {ms:.3f} ms (median "
                  f"of 5), {4 * v * n / ms / 1e6:.1f} GB/s, "
                  f"{100 * bound_ms / ms:.1f}% of the bound; "
                  f"max|field - shipped| {err:.3e}")
        ms = median_ms(lambda: pearson_cuda(series, ref))
        print(f"[ablate K1 {card}] {label} the wrapper pearson_cuda: "
              f"{ms:.3f} ms (median of 5)")
        del series, ref, out, shipped


def headline_composite(dev):
    """The 1080p headline frame's K2 slices and composite geometry."""
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
    from correrender_tpu_torch.render.dvr_fast import composite_inputs
    from correrender_tpu_torch.render.pipeline import render_correlation_fast
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    gen = torch.Generator(device=dev).manual_seed(0)
    stack = synth_box_stack(250, 250, 250, 100, gen, dev)
    stages = {}
    render_correlation_fast(stack, (62, 62, 125), config1_camera(),
                            config1_transfer_function(dev),
                            image_size=(1920, 1080), intermediate_scale=0.75,
                            on_stage=stages.__setitem__)
    torch.cuda.synchronize()
    del stack
    geo = stages["composite"][2]
    return stages["classify"]["cf"], composite_inputs(geo, dev)


def composite_buffers(cf, len_factor):
    """The tap scratch, rgb and alpha of one K3 call."""
    s = cf.shape[0]
    hi, wi = len_factor.shape
    return (torch.empty((s * (hi + wi), 2), dtype=torch.int32,
                        device=cf.device),
            torch.empty((hi, wi, 3), dtype=torch.float32, device=cf.device),
            torch.empty((hi, wi), dtype=torch.float32, device=cf.device))


def composite_probe(cf, args: dict, which: int, buffers=None, lib=None):
    """K3's probe variant ``which`` (``correrender_shearwarp_composite_probe``)
    on the keyword arguments of ``shearwarp_composite`` (attenuation and
    kstop among them): ``(rgb, alpha)``, in ``buffers`` if given. Counts
    no launch: no entry point's path runs it."""
    s, yv, xv, _ = cf.shape
    hi, wi = args["len_factor"].shape
    taps, rgb, alpha = buffers or composite_buffers(cf, args["len_factor"])
    kstop = args.get("kstop")
    e_u, e_v = (float(e) for e in args["eye_uv"])
    _build.check((lib or _build.library()).correrender_shearwarp_composite_probe(
        cf.data_ptr(), s, yv, xv, *(args[k].data_ptr() for k in (
            "g", "coords_y", "coords_x", "grid_v", "grid_u", "len_factor")),
        None if kstop is None else kstop.data_ptr(), hi, wi, e_u, e_v,
        float(args["slab_thickness"]), float(args["attenuation"]),
        taps.data_ptr(), rgb.data_ptr(), alpha.data_ptr(), which,
        cf.device.index, _build.stream_of(cf)), "shearwarp_composite_probe")
    return rgb, alpha


def ablate_k3(lib, parent, card: str, dev) -> None:
    cf, args = headline_composite(dev)
    s, yv, xv, _ = cf.shape
    hi, wi = args["len_factor"].shape
    args["attenuation"] = 100.0  # render_correlation_fast's
    # A stop ramp across the image: from a quarter to three quarters of
    # the slices.
    ramp = torch.linspace(0.25 * s, 0.75 * s, wi, device=dev)
    kstops = {"no kstop": None, "kstop ramp": ramp.expand(hi, wi).contiguous()}
    buffers = composite_buffers(cf, args["len_factor"])
    _, rgb, alpha = buffers
    print(f"[ablate K3 {card}] 1920x1080 headline composite: {s} slices of "
          f"{yv}x{xv}, intermediate {hi}x{wi}, {s * hi * wi} samples")

    def image():
        return torch.cat([rgb.reshape(-1), alpha.reshape(-1)]).clone()

    for label, kstop in kstops.items():
        run_args = dict(args, kstop=kstop)

        def probe(which, run_args=run_args):
            return lambda: composite_probe(cf, run_args, which, buffers, lib)

        images = {}
        for _, which in K3_VARIANTS:
            probe(which)()
            torch.cuda.synchronize()
            images[which] = image()
        shipped = images[0]
        for which in K3_EQUAL_TO_SHIPPED:
            assert torch.equal(images[which], shipped), (label, which)
        inline = images[1]
        print(f"[ablate K3 {card}] {label}: max|shipped - inline taps| "
              f"{float((shipped - inline).abs().max()):.3e}, max|q fused - inline "
              f"taps| {float((images[2] - inline).abs().max()):.3e}, "
              f"pixels with alpha exactly 1: "
              f"{100 * float((alpha == 1.0).float().mean()):.2f}%")
        runs = [(name, probe(which)) for name, which in K3_VARIANTS]
        if parent is not None:
            def parent_run(kstop=kstop):
                _build.check(parent.correrender_shearwarp_composite(
                    cf.data_ptr(), s, yv, xv, *(args[k].data_ptr() for k in (
                        "g", "coords_y", "coords_x", "grid_v", "grid_u",
                        "len_factor")),
                    None if kstop is None else kstop.data_ptr(), hi, wi,
                    *(float(e) for e in args["eye_uv"]),
                    float(args["slab_thickness"]), args["attenuation"],
                    rgb.data_ptr(), alpha.data_ptr(), dev.index,
                    _build.stream_of(cf)), "parent shearwarp_composite")
            parent_run()
            torch.cuda.synchronize()
            err = float((image() - inline).abs().max())
            print(f"[ablate K3 {card}] {label}: max|parent's kernel - inline "
                  f"taps| {err:.3e}, max|parent's kernel - shipped| "
                  f"{float((image() - shipped).abs().max()):.3e}")
            runs.append(("the parent's kernel", parent_run))
        runs.append((K3_VARIANTS[0][0], runs[0][1]))
        for name, run in runs:
            ms = median_ms(run)
            print(f"[ablate K3 {card}] {label} {name}: {ms:.3f} ms (median "
                  f"of 5), {s * hi * wi / ms / 1e6:.4g} Gsamples/s")
        split_shipped(runs[0][1], card, label)


def split_shipped(run, card: str, label: str, calls: int = 3) -> None:
    """Device time of the shipped call's two kernels under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            name = ("tap pre-pass" if "composite_taps_kernel" in event.key
                    else "composite" if "composite_kernel" in event.key
                    else event.key)
            print(f"[ablate K3 {card}] {label} shipped, {name}: "
                  f"{event.self_device_time_total / 1e3 / calls:.3f} ms "
                  f"device (profiler, {calls} calls)")


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
    ablate_k1(lib, parent, card, dev)
    ablate_k3(lib, parent, card, dev)


if __name__ == "__main__":
    main()
