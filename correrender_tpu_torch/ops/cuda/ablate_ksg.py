"""Where B9's time goes: variants of ``csrc/ksg.cu`` timed on the card,
beside an earlier commit's B9.

    python3 -m correrender_tpu_torch.ops.cuda.ablate_ksg [--parent DIR]

Each variant changes one part of the shipped source by a textual
substitution (which must apply once) and is built into its own library
under ``build/ablate_ksg/``, one ``nvcc`` per variant, all started
together, with the flags of ``_build.build``. The inputs are those of
``chip_smoke.py``'s members phase: 48³ × 1000 independent normal series
(seed 3, reference at the centre), k = 3 and the wrapper's noise, passed
to the C entry as ``mi_ksg_cuda`` passes them. The variants are timed on
the first 4096 voxels with estimator 1.

The exact variants give the shipped kernel's per-point counts, which the
script checks, and its ψ sums up to the order of the sum:

- "strided rows": a lane's rows 32 apart (rows first + 32·t, lanes on
  consecutive rows) and the arrays unswizzled, the layout whose reads
  are conflict-free without a swizzle;
- "no swizzle": the shipped rows (consecutive, lanes kRows apart) with
  the arrays unswizzled, so the lanes' reads conflict;
- "rows 1", "rows 2", "half the rows": rows a lane in the
  k-th-distance pass (shipped: 8 at k ≤ 3, 4 at k ≤ 7, else 2);
- "scan from rank 0": every lane scans outward from the first point in
  x order instead of from the middle of its own rows;
- "no vote": each lane branches on its own compares, without the warp
  vote;
- "three blocks an SM": a launch bound that caps the registers so that
  three blocks of 8 warps fit an SM;
- "checked pushes": each push in the vote's branch checks d < top[0]
  first (KSmallest::push) instead of running the network for every d;
- "extents row by row": estimator 2's extents by one walk a row over
  its own window (walk_extents, as B10 finds them), timed with
  estimator 2 too.

The probes compute wrong answers on purpose; the time a probe saves is
what the part it drops costs:

- "min only": a push keeps only the minimum (after the point itself,
  0, nothing beats it): the scan without its pushes;
- "no k-th pass": r = 1 for every point (the searches and sort run);
- "no counts": the four binary searches are not run.

With ``--parent DIR`` (a checkout of an earlier commit) the script also
builds that commit's ``ksg.cu`` alone, with its own ``ksg_common.cuh``,
and calls its ``correrender_mi_ksg`` with the earlier C signature
(series, noised reference, y noise, ψ sums, counts, v, n, k, estimator,
device, stream), checking its counts equal to the shipped kernel's.

Prints one line per run: the median of 5 CUDA-event timings, the parent
first and last and the shipped kernel second and second to last; then
the shipped and parent kernels on the subset with estimator 2 and on
the whole field (110,592 voxels) with estimator 1, and the wrapper
``mi_ksg_cuda`` on the subset; with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.ablate_ksg_banded import (
    build_variants,
    median_ms,
)
from correrender_tpu_torch.ops.cuda.ablate_spearman import card_line

ROWS = "  constexpr int kRows = KP1 <= 4 ? 8 : KP1 <= 8 ? 4 : 2;\n"
LAYOUT = ("  constexpr int kRowStep = 1, kLaneStep = kRows, kSwizzle = "
          "kRows;\n")
VOTE = "      if (__any_sync(kFullMask, beats)) {\n"
INSERT = ("          best[t].insert(du[t], KP1);\n"
          "          best[t].insert(dd[t], KP1);\n")
VARIANTS = {
    "shipped": [],
    "strided rows": [(LAYOUT, "  constexpr int kRowStep = kWarp, kLaneStep "
                              "= 1, kSwizzle = 1;\n")],
    "no swizzle": [(LAYOUT, "  constexpr int kRowStep = 1, kLaneStep = "
                            "kRows, kSwizzle = 1;\n")],
    "rows 1": [(ROWS, "  constexpr int kRows = 1;\n")],
    "rows 2": [(ROWS, "  constexpr int kRows = 2;\n")],
    "half the rows": [(ROWS, "  constexpr int kRows = KP1 <= 4 ? 4 : KP1 <= 8 "
                              "? 2 : 1;\n")],
    "scan from rank 0": [(
        "    int up = min(first + STEP * (ROWS - 1) / 2, n - 1);\n",
        "    int up = 0;\n")],
    "no vote": [(VOTE, "      if (beats) {\n")],
    "three blocks an SM": [(
        "template <int KP1>\n__global__ void ksg_kernel(",
        "template <int KP1>\n__global__ void __launch_bounds__(256, 3) "
        "ksg_kernel(")],
    "checked pushes": [(INSERT, ("          best[t].push(du[t], KP1);\n"
                                 "          best[t].push(dd[t], KP1);\n"))],
    "extents row by row": [(
        "    if (estimator == 2) rows.extents(xs, ys, n, r, ex, ey);\n",
        "    for (int t = 0; t < kRows; ++t) {\n"
        "      const int i = rows.first + kRowStep * t;\n"
        "      if (estimator == 2 && i < n) {\n"
        "        walk_extents<kSwizzle>(xs, ys, n, xs[swizzled<kSwizzle>(i)], "
        "ys[swizzled<kSwizzle>(i)], r[t], i - 1, i + 1, &ex[t], &ey[t]);\n"
        "      }\n"
        "    }\n")],
    "min only": [(INSERT, (
        "          best[t].top[0] = fminf(best[t].top[0], "
        "fminf(du[t], dd[t]));\n"))],
    "no k-th pass": [("    rows.kth(xs, ys, n, r);\n",
                      "    for (int t = 0; t < kRows; ++t) r[t] = 1.0f;\n")],
    "no counts": [(
        "      marginal_counts<kSwizzle>(xs, ysorted, n, npow2, xi, yi, rx, "
        "ry, &cx,\n                                &cy);\n",
        "      cx = cy = 1 + (rx > 0.0f) + (ry > 0.0f);\n")],
}
EXACT = ("shipped", "strided rows", "no swizzle", "rows 1", "rows 2",
         "half the rows", "scan from rank 0", "no vote", "three blocks an SM",
         "checked pushes", "extents row by row")
# Also timed with estimator 2.
EST2 = ("extents row by row",)
SUBSET, K = 4096, 3
# The earlier entry: series, x_noised, y_noise, psi_sum, counts, v, n, k,
# estimator, device, stream.
PARENT_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [
    ctypes.c_int] * 4 + [ctypes.c_void_p]


def start_parent(root: Path):
    """Start building the parent checkout's ksg.cu alone; returns (path
    of the library, the nvcc process)."""
    csrc = root / "correrender_tpu_torch" / "ops" / "cuda" / "csrc"
    out = _build._BUILD_DIR.parent / "ablate_ksg" / "parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    return out, subprocess.Popen(
        [_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-lineinfo", "-I", str(csrc), "-o", str(out),
         str(csrc / "ksg.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_parent(path: Path, proc) -> ctypes.CDLL:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's ksg.cu:\n{out}")
    lib = ctypes.CDLL(str(path))
    lib.correrender_mi_ksg.argtypes = PARENT_SIGNATURE
    lib.correrender_mi_ksg.restype = ctypes.c_int
    return lib


def main() -> None:
    from correrender_tpu_torch.ops.cuda.ksg_kernel import (
        mi_ksg_cuda, noised_reference, sorted_reference)

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="checkout of an earlier commit to time too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the ablation runs on the card")
    card = card_line()
    dev = torch.device("cuda", 0)
    pending = start_parent(args.parent) if args.parent else None
    libs = build_variants("ksg.cu", VARIANTS, "correrender_mi_ksg",
                          "ablate_ksg")
    parent = load_parent(*pending) if pending else None
    gen = torch.Generator(device=dev).manual_seed(3)
    stack = torch.randn((48, 48, 48, 1000), generator=gen, device=dev)
    ref = stack[24, 24, 24].clone()
    field = stack.reshape(-1, 1000)
    sub = field[:SUBSET]
    perm, xs, y_noise = sorted_reference(ref, True, None)
    x = noised_reference(ref, True, None)[0]  # the parent's, unsorted
    stream = _build.stream_of(field)

    def run(lib, series, est=1, counts=None):
        """One launch of ``lib``'s B9 on ``series``; its (V,) ψ sums."""
        v, n = series.shape
        psi = torch.empty(v, dtype=torch.float32, device=dev)
        c = counts.data_ptr() if counts is not None else None
        if lib is parent:
            err = lib.correrender_mi_ksg(
                series.data_ptr(), x.data_ptr(), y_noise.data_ptr(),
                psi.data_ptr(), c, v, n, K, est, dev.index, stream)
        else:
            err = lib.correrender_mi_ksg(
                series.data_ptr(), perm.data_ptr(), xs.data_ptr(),
                y_noise.data_ptr(), psi.data_ptr(), c, v, n, K, est,
                dev.index, stream)
        _build.check(err, "mi_ksg")
        return psi

    def with_counts(lib, est):
        """``lib``'s ψ sums and per-point counts on the subset."""
        counts = torch.empty((SUBSET, 1000, 2), dtype=torch.int32,
                             device=dev)
        psi = run(lib, sub, est, counts)
        torch.cuda.synchronize()
        return psi, counts

    for est in (1, 2):
        want_psi, want = with_counts(libs["shipped"], est)
        others = [n for n in EXACT if n != "shipped" and (est == 1
                                                          or n in EST2)]
        others += ["parent"] if parent is not None else []
        for name in others:  # counts equal, ψ/n within the MI bar
            lib = parent if name == "parent" else libs[name]
            psi, counts = with_counts(lib, est)
            assert torch.equal(counts, want), (name, est, "counts")
            err = float(((psi - want_psi) / 1000).abs().max())
            assert err <= 1e-5, (name, est, err)
            print(f"[ablate B9 {card}] estimator {est} {name}: counts equal "
                  f"to the shipped kernel's, max|Δψ|/n {err:.3e}")

    ends = [("parent", parent)] if parent is not None else []
    order = ends + [(name, libs[name]) for name in VARIANTS]
    order += [("shipped", libs["shipped"])] + ends
    for name, lib in order:
        ms = median_ms(lambda: run(lib, sub))
        kind = "probe" if name in VARIANTS and name not in EXACT else "exact"
        print(f"[ablate B9 {card}] 48^3 x 1000, {SUBSET} voxels, estimator "
              f"1, {name} ({kind}): {ms:.3f} ms (median of 5)")
    for label, series, est in ((f"{SUBSET} voxels, estimator 2", sub, 2),
                               ("the whole field, estimator 1", field, 1)):
        runs = [("shipped", libs["shipped"])]
        if est == 2:
            runs += [(name, libs[name]) for name in EST2] + runs
        runs = ends + runs + ends
        for name, lib in runs:
            ms = median_ms(lambda: run(lib, series, est))
            print(f"[ablate B9 {card}] 48^3 x 1000, {label}, {name}: "
                  f"{ms:.3f} ms (median of 5)")
    ms = median_ms(lambda: mi_ksg_cuda(sub, ref))
    print(f"[ablate B9 {card}] 48^3 x 1000, {SUBSET} voxels, the wrapper "
          f"mi_ksg_cuda (noise, x order, the shipped kernel, MI): "
          f"{ms:.3f} ms (median of 5)")


if __name__ == "__main__":
    main()
