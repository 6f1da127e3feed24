"""Where B7's time goes: variants of ``csrc/spearman.cu`` timed on the
card.

    python3 -m correrender_tpu_torch.ops.cuda.ablate_spearman [--parent DIR]

The variants are template instances of the register path that only this
script launches, through ``correrender_spearman_probe`` in the shipped
library. Each is timed on the Spearman field's two shapes: the 250³ ×
100 headline stack of ``chip_smoke.py`` (``synth_box_stack``, seed 0,
reference at (62, 62, 125)) and 48³ × 1000 independent normal series
(seed 3, reference at the centre), through the C entries with the
arguments ``spearman_cuda`` passes them.

- "8 lanes", "16 lanes", "32 lanes" at n = 100, and "32 lanes" at
  n = 1000: the shipped scheme (a sort in each lane's registers, then
  merges by merge path through shared memory) at other widths, whose
  moments the script checks equal to the shipped kernel's;
- "bitonic across lanes": the order by a bitonic network whose strides
  of E and above run by __shfl_xor_sync between the lanes' registers
  (the first design), checked equal too;
- "no sort": the keys are not sorted (the run scan and the sums still
  run), so its time less the shipped time is the sort's;
- "no tie scan": 2r = 2p + 2 at each sorted position, no run bounds;
  the saving is the scan's.

The two probes compute wrong answers on purpose. With ``--parent DIR``
(a checkout of an earlier commit) the script also builds that commit's
``spearman.cu`` on its own and times its ``correrender_spearman`` on the
same inputs, checking its moments equal too. Prints one line per
variant and shape: the median of 5 CUDA-event timings, the shipped
kernel first and last, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.ablate_ksg_banded import median_ms

# (label, lanes, probe) per shape; probe 0 is the shipped scheme.
VARIANTS = {
    100: [("8 lanes (shipped width)", 8, 0), ("16 lanes", 16, 0),
          ("32 lanes", 32, 0), ("bitonic across lanes", 8, 3),
          ("no sort", 8, 1), ("no tie scan", 8, 2)],
    1000: [("32 lanes (shipped width)", 32, 0),
           ("bitonic across lanes", 32, 3), ("no sort", 32, 1),
           ("no tie scan", 32, 2)],
}
EXACT_PROBES = (0, 3)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def build_parent(root: Path):
    """The parent checkout's spearman.cu, built alone; its library."""
    csrc = root / "correrender_tpu_torch" / "ops" / "cuda" / "csrc"
    out = _build._BUILD_DIR.parent / "ablate_spearman" / "parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-I", str(csrc), "-o", str(out),
         str(csrc / "spearman.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.correrender_spearman.argtypes = _build._SIGNATURES[
        "correrender_spearman"]
    lib.correrender_spearman.restype = ctypes.c_int
    return lib


def shapes(dev):
    """(label, (V, n) series, (n,) reference) of the two fields."""
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
    from correrender_tpu_torch.ops.cuda.spearman_kernel import spearman_cuda
    from correrender_tpu_torch.ops.spearman import doubled_ranks

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
    for label, series, ref in shapes(dev):
        v, n = series.shape
        xr = doubled_ranks(ref).to(torch.int32)
        stream = _build.stream_of(series)

        def sums_of(call):
            sums = torch.empty((v, 3), dtype=torch.int64, device=dev)
            _build.check(call(sums), "spearman")
            return sums

        def shipped(sums, fn=lib.correrender_spearman):
            return fn(series.data_ptr(), xr.data_ptr(), sums.data_ptr(), v,
                      n, dev.index, stream)

        def variant(lanes, probe):
            return lambda sums: lib.correrender_spearman_probe(
                series.data_ptr(), xr.data_ptr(), sums.data_ptr(), v, n,
                lanes, probe, dev.index, stream)

        want = sums_of(shipped)
        runs = [("shipped", shipped)]
        runs += [(name, variant(lanes, probe))
                 for name, lanes, probe in VARIANTS[n]]
        if parent is not None:
            runs.append(("parent's kernel", lambda sums: shipped(
                sums, parent.correrender_spearman)))
        runs.append(("shipped", shipped))
        for name, call in runs:
            probe = dict((k, p) for k, _, p in VARIANTS[n]).get(name, 0)
            kind = "exact" if probe in EXACT_PROBES else "probe"
            if kind == "exact":
                assert torch.equal(sums_of(call), want), (label, name)
            out = torch.empty((v, 3), dtype=torch.int64, device=dev)
            ms = median_ms(lambda: _build.check(call(out), "spearman"))
            print(f"[ablate B7 {card}] {label} {name} ({kind}): {ms:.3f} ms "
                  f"(median of 5)")
        ms = median_ms(lambda: spearman_cuda(series, ref))
        print(f"[ablate B7 {card}] {label} the wrapper spearman_cuda "
              f"(reference ranks, the shipped kernel, rho): {ms:.3f} ms "
              f"(median of 5)")


if __name__ == "__main__":
    main()
