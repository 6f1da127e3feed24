"""Where B10's time goes: variants of ``csrc/ksg_banded.cu`` timed on
the card.

    python3 -m correrender_tpu_torch.ops.cuda.ablate_ksg_banded

Each variant changes one part of the shipped source by a textual
substitution (which must apply) and is built into its own library under
``build/ablate/``, one ``nvcc`` per variant, all started together. Each
is timed on the KSG field's two shapes: the 250³ × 100 headline stack of
``chip_smoke.py`` (``synth_box_stack``, seed 0, reference at (62, 62,
125)) and 48³ × 1000 independent normal series (seed 3, reference at the
centre), with estimator 1, k = 3 and the wrapper's noise, through the C
entry with the arguments ``ksg_banded.banded_psi_sums`` passes it.

The walk widths give the shipped ψ sums exactly, which the script checks.
The other variants are timing probes that compute wrong answers on
purpose; the time a probe saves is what the part it drops costs:

- "no walk": no neighbour is pushed, so r stays +inf and every count
  is n (the searches still run);
- "one round": the walk stops after one round a side (17 points);
- "no y sort": the voxel's copy of y is not sorted (the y counts still
  run their binary searches);
- "no counts": the four binary searches are not run;
- "no points": no point is processed (load, gather, sort, ψ table).

Prints one line per variant and shape: the median of 5 CUDA-event
timings, the variants run in the order given, the shipped source first
and last, then the wrapper's own launch helper (the same kernel with the
host's noise and x order), with the card's name and power limit. The
variants are built with the flags of ``_build.build``.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

from correrender_tpu_torch.ops.cuda import _build

WALK = "constexpr int kWalkWidth = 8;"
VARIANTS = {
    "shipped": [],
    "walk width 1": [(WALK, "constexpr int kWalkWidth = 1;")],
    "walk width 4": [(WALK, "constexpr int kWalkWidth = 4;")],
    "walk width 16": [(WALK, "constexpr int kWalkWidth = 16;")],
    "no walk": [("  while (down || up) {\n", "  while (false) {\n")],
    "one round": [("  while (down || up) {\n",
                   "  for (int once = 0; once < 1; ++once) {\n")],
    "no y sort": [("  sort_y<LANES>(ysorted, npow2, sub);\n", "")],
    "no counts": [(
        "      marginal_counts(xs, ysorted, n, npow2, xi, yi, rx, ry, &cx, "
        "&cy);\n",
        "      cx = cy = 1 + (rx > 0.0f) + (ry > 0.0f);\n")],
    "no points": [("  if (live && !nan) {\n", "  if (false) {\n")],
}
EXACT = ("shipped", "walk width 1", "walk width 4", "walk width 16")


def build_variants(source: str = "ksg_banded.cu", variants=None,
                   entry: str = "correrender_mi_ksg_banded",
                   subdir: str = "ablate") -> dict:
    """Build every variant of ``csrc/<source>`` (default: this script's
    own) under ``build/<subdir>/``; returns {name: loaded ctypes
    library} with ``entry`` bound."""
    import ctypes

    src = (_build._CSRC / source).read_text()
    header = (_build._CSRC / "ksg_common.cuh").read_text()
    root = _build._BUILD_DIR.parent / subdir
    procs = {}
    for i, (name, subs) in enumerate((variants or VARIANTS).items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: substitution does not apply: "
                                   f"{old!r}")
            text = text.replace(old, new)
        d = root / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "ksg_common.cuh").write_text(header)
        (d / source).write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
             "-o", str(d / "lib.so"),
             str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def median_ms(fn, reps: int = 5) -> float:
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


def shapes(dev):
    """(label, (V, n) series, (n,) reference) of the two KSG fields."""
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


def main() -> None:
    from correrender_tpu_torch.ops.cuda.ksg_banded import (
        band_width, banded_psi_sums)
    from correrender_tpu_torch.ops.cuda.ksg_kernel import sorted_reference

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the ablation runs on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    dev = torch.device("cuda", 0)
    libs = build_variants()
    for label, series, ref in shapes(dev):
        v, n = series.shape
        w = band_width(n, 3)
        perm, xs, y_noise = sorted_reference(ref, True, None)

        def psi_sums(lib):
            psi = torch.empty(v, dtype=torch.float32, device=dev)
            err = lib.correrender_mi_ksg_banded(
                series.data_ptr(), perm.data_ptr(), xs.data_ptr(),
                y_noise.data_ptr(), psi.data_ptr(), None, None, v, n, w, 3,
                1, dev.index, _build.stream_of(series))
            if err:
                raise RuntimeError(f"mi_ksg_banded: CUDA error {err}")
            return psi

        shipped = psi_sums(libs["shipped"])
        wrapper = banded_psi_sums(series, ref, 3, 1, True, None, w, False)[0]
        assert torch.equal(shipped, wrapper), label
        for name in EXACT:
            assert torch.equal(psi_sums(libs[name]), shipped), (label, name)
        for name in [*VARIANTS, "shipped"]:
            ms = median_ms(lambda: psi_sums(libs[name]))
            kind = "exact" if name in EXACT else "probe"
            print(f"[ablate B10 {card}] {label} {name} ({kind}): {ms:.3f} ms "
                  f"(median of 5)")
        ms = median_ms(lambda: banded_psi_sums(series, ref, 3, 1, True, None,
                                               w, False))
        print(f"[ablate B10 {card}] {label} the wrapper's banded_psi_sums "
              f"(noise, x order, the shipped kernel): {ms:.3f} ms "
              f"(median of 5)")


if __name__ == "__main__":
    main()
