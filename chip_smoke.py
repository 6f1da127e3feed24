#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``correrender_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each asserting; any failure exits non-zero:

1. Device: a CUDA device must be present (there is no CPU path); prints
   the card's name and power limit.
2. Build: compiles the hand-written sm_90a kernels from
   ``correrender_tpu_torch/ops/cuda/csrc`` (one nvcc per source, all at
   once, into build/kernels/).
3. Kernels against their plain PyTorch versions on the card: K1 Pearson
   at n = 1-5, 37, 100, 128, 129, 1000, 1025, 2048, 2049 and 4096 on
   2053 voxels (its lane and tiling boundaries, a ragged last tile, a
   zero-variance row), on 12- and 20-byte stacks, an offset view (the
   direct regime) and 250³ × 100; K2 classify (NaN, degenerate domain,
   every slice orientation); K3 composite on the tests' setup with and
   without kstop, hi and wi that no tile divides, S = 1, Yv = 1, Xv = 1,
   inert and missed slices and saturated rays, with its probe variants
   (``ablate_fast_path.py``): the unpacked, 1- and 4-pixel and exit
   variants equal to the kernel, and its difference from the inline-tap
   arithmetic of the first kernel (and of the tables with q fused as that
   kernel fused it, 0.0 expected) printed; B3 classify_volume (NaN,
   ±inf, degenerate domain; n = 1, 3, 5 and 15,673, which leave part of
   a warp's 128-voxel chunk, and an offset view; its probe layout of 4
   consecutive voxels a thread equal to it), B5 exact marcher at 64³ and 512×288 (six
   orientations, NaN ignore and yellow, restriction in both metrics, a
   depth-limit plane, a rotated model matrix, transfer functions of 7
   and 21 knots); B7 Spearman, B8 Kendall,
   B9 KSG and B10 (the pruned x-order scan) at n = 37, 250 and 1000 with
   ties, a repeated member, a NaN voxel and a zero-variance voxel, each
   with a continuous and a quantized reference; B8 also at n = 1, 2, 33
   and 4096; B7 also at n = 1, 2, 32, 33, 100, 128, 129, 1024, 1025 and
   4096 (its lane, register and shared-memory boundaries) with rows of
   signed zeros and a third reference (signed zeros and a NaN member);
   KSG with both estimators, per-point counts equal, B10 at
   band widths 192 and 16 against B9, on mass ties without noise, a
   mass-tied reference at n = 1000, five voxels at the shared-memory
   limit n = 12288, and independent series at n = 1000 (B10's longest
   scans).
4. BASELINE config 1 at its own size (128×128×32, 100 members,
   1280×720): ``render_correlation_fast`` through the kernels against the
   same function on the CPU (one thread), where it runs the plain
   versions; each kernel's launch counter must move.
5. Config 1 at the headline grid (250³ voxels × 100 members drawn on the
   card, 1920×1080, intermediate scale 0.75): the main path once with
   counted launches; each kernel against its plain version on the inputs
   the main path gave it (K3 also against the inline-tap arithmetic);
   the median of 5 frames' stage times (CUDA
   events at the stage boundaries of ``render_correlation_fast``, through
   its ``on_stage`` hook), each beside the plain version's time on the
   same inputs; the peak device memory.
6. Where the time goes: 3 headline frames under ``torch.profiler``, the
   device time per kernel group and the device's busy share.
7. Exact headline: the same 250³ × 100 stack, the K1 field, then
   ``dvr_render_exact`` at 1920×1080, voxel step 0.1 (q = 10), with
   config 1's camera and control-point TF: counted launches, B5 against
   its plain version on the same prepared inputs (which also counts the
   samples the rays took), the median of 5 frame times, B5's time beside
   the plain version's (3 plain runs) and its samples/s, the peak
   memory, and a
   ``torch.profiler`` split of 3 frames.
8. Restricted and depth-clipped fast frame at the headline: the field →
   ``classify_volume`` (B3) × ``restriction_mask`` (radius 0.1 around the
   reference point) → ``dvr_shearwarp(classified=, depth_limit=)`` (K3
   with kstop): counted launches, B3 against its plain version; B3's
   time as 21 launches into one output, each timed alone (median, min,
   max), beside the wrapper's, the plain version's and the probe
   layout's (4 consecutive voxels a thread).
9. The measure switch on the same stack: the Spearman, Kendall and KSG
   fields through ``correlate_field`` (B7, B8, B10) with counted
   launches, each held to its plain version on every 997th voxel, the
   median of 5 field times beside the bound, a table row per kernel
   (launches, field, bound, kernel and plain on every 997th voxel); then
   a 1920×1080 KSG frame through
   ``render_correlation_fast(..., "mi_kraskov")`` (B10, K2, K3, warp):
   counted launches, the stage split and the peak memory.
10. Eye-inside frame: a camera inside the volume through
   ``render_correlation_fast`` (→ ``dvr_render``, no kernel) at config
   1's own size, against the same marcher run on the CPU (one thread,
   every 24th row of the same rays), and its time.
11. BASELINE configs 2 (96×64×32 × 250, Spearman and Kendall) and 3
   (48×48×24 × 500, binned MI and KSG) through their own entry points,
   with counted launches: the fields they timed against
   ``correlate_field`` on the CPU (one thread) on every 16th voxel, and
   their median of 5 field times.
12. 48³ × 1000 members (the JAX bench's KSG size): the Spearman, Kendall
   and KSG fields through ``correlate_field`` (B7, B8, B10) once each
   with counted launches, and B9 through ``mi_ksg_cuda`` (no entry point
   reaches it: B10 scans exactly); the field times beside the whole
   field's bound, each kernel
   against its plain version on a 4096-voxel subset with both times and
   the bound, the share of B10's points whose answer needs a point
   outside the rank band of 192, binned MI's torch time.
13. B6 (the iso marcher) against its plain version at 64³ and 512×288:
   cameras along each axis, with and without flip, a model matrix, a
   NaN voxel, rays along the box's edge (an odd width: the middle
   column's slab test meets 0·inf), the eye inside the box, hits in the
   first and in the last slab, q = 1 and 10, one and two planes, one
   voxel across the sub or the lane axis, each with ``refine_steps`` 8
   and 0; found masks and ray directions equal, bars on t and on the
   gradients. B1 (chunk moments) against its plain version:
   float32 and bfloat16, E = 50 and 13, V = 250³ and an odd V, the
   accumulating form against the separate one; ``pearson_streamed`` of a
   64³ × 1000 stack in 50-member chunks against K1's field.
14. The iso frame (run after phase 8, on the headline stack): the K1
   field → ``iso_render_exact(..., 0.5)`` at 1920×1080, voxel step 0.25
   (q = 4), config 1's camera: counted launches (B6 once, and no torch
   ray setup: ``_ray_fields``, ``iso_ray_fields`` and ``Camera.rays``
   are counted and must not run), B6 against
   its plain version on the same prepared inputs (with the samples the
   rays took, for the bound), the frame from the plain outputs against
   the frame, the median of 5 frames' stage times (``on_stage``: layout,
   march, shade), the plain version's torch ray fields' time, a
   ``torch.profiler`` split
   and busy share, and the same frame with the "marmitt" solver (B6
   without refinement, then the torch tail).
15. ``iso_render`` (plain torch) on config 1's field at 1280×720: card
   against the same marcher on the CPU (one thread, every 24th row of
   the same rays), and its time.
16. The streamed headline as the JAX repo's bench.py shapes it: two
   resident 50-member chunks of 250³ voxels, used alternately for 20
   chunks against a 1000-member reference, in float32 and in bfloat16:
   ``pearson_streamed`` with counted launches (20 per field), the field
   against a float64 Pearson of every 997th voxel, the median of 5 field
   times, Gvoxels/s, effective GB/s and the bound; B1 per chunk against
   its plain version's time and the three-call torch formulation
   (``sum``, ``sum`` of squares, ``ref @ chunk``), and the bfloat16
   chunk's kernel time beside its bound.
17. The Scene at the headline (run after phase 9, on the same stack):
   a ``VolumeData`` on the card served member by member from the stack
   (the time to build its member stack), a Pearson
   ``CorrelationCalculator`` and a ``Scene`` at 1920×1080 with config
   1's camera and TF. For each interaction, counted launches, the
   median of 5 frames (CUDA events; each frame makes its change and
   renders) and the frame against the direct call on the same inputs:
   (a) the reference point moved (K1, K2, K3, the warp); (b) the camera
   moved within its principal axis (no K2: the layout is reused); (c)
   the TF changed (K2, K3); (d) ``quality="exact"`` (B5); (e) ``iso_ray``
   exact (B6) and fast (``render/iso_fast.py``, no kernel; its first-hit
   scan held to the same scan on the CPU, one thread, on every 24th row
   of the intermediate rays); (f) ``iso_ray`` and ``dvr`` in one view
   (the depth merge, then K3 with kstop); (g) a restricted calculator
   (B3), and its ``iso_ray`` frame (B6 on the NaN-filled slab, the
   layout built each frame, beside the same call with the layout built
   once). Also the direct call's time, the cache's bytes and the peak
   memory; and the fast iso frame at config 1's size against the CPU.
18. (Run after phase 4, before any ``torch.profiler`` window: later in
   the run short windows came back without device events.) BASELINE
   config 4 through its own entry point on the card, its
   Scene frames held to the same Scene on the CPU; then a time-dependent
   store at the headline's grid: 250³ voxels × 40 time steps, one
   member, float32, written as uncompressed Zarr chunks of one step
   under build/ (deleted after the phase), opened by ``load_volume``, a
   time-mode calculator with ``time_lag=2`` (n = 38) and
   ``render_flythrough`` of ``orbit_path(8)`` at 1920×1080 stepping the
   time: the load, time-stack and field times, the field against a
   float64 Pearson of every 997th voxel, K1 in its tiled regime for lags
   +2 and −2 (``torch.profiler`` names ``pearson_tiled_kernel``), the
   frames' launches and time, how often the field was computed, the most
   frames in flight and the peak memory.
19. The Scene's view content (run after phase 17 on its ``VolumeData`` of
   the headline stack; no ``torch.profiler`` window). The view: ``dvr``,
   an axis slice (z, 0.5), an oblique slice (normal 1, 1, 1; lighting
   0.5; NaN yellow; fix_on_ground), the domain outline, a shapefile and a
   graticule world map (the shapefile written under build/views and
   deleted after the phase), the reference-point marker and the legend.
   (a) At config 1's size (128×128×32 × 100, 1280×720) on the card,
   counted launches (K1, K2, K3 once each), against the same Scene on
   the CPU (one thread). (b) At the headline (1920×1080): counted
   launches, the median of 5 frames (CUDA events, the change included),
   the frame against the direct call of the same renderers, the direct
   call's time and the peak memory, for (h) the reference point moved
   (K1, K2, K3 with kstop from the slices' and the outline's depth),
   (i) the camera moved within its principal axis and (j) the point
   moved without the marker, the legend and the maps; then each part of
   (h)'s direct call timed alone. (c) The state
   round trip: ``save_state(reference_format=True)``, ``load_state`` on
   the same ``VolumeData``, the frames equal within 1e-6 (the view with
   a TF read from the widget's XML, which the export writes back point
   for point, and without the shapefile map: the reference format has
   no key for its path, so both packages import it as the graticule).
20. The derived-field calculators (run after phase 19 on phase 17's
   ``VolumeData``). (a) At config 1's grid (128×128×32 × 100, and u, v, w
   × 10 members of an analytic flow drawn on the host), each field
   against the same calculator on the CPU (one thread) on the same
   inputs, at the CPU tests' bars: ensemble mean and spread, DKL binned
   (80 bins; off the bin edges, and at most the near-edge voxels moved)
   and kNN (k = 3; NaN in the same voxels), the set predicate (fraction,
   and count range), noise reduction (σ = 1) of the mean, the binary
   operator (the mean minus its blur), residual colour, field similarity
   (Pearson, Kendall) of mean and spread, vector magnitude, vorticity,
   helicity and the spread of helicity. (b) The same fields at the
   headline (250³ × 100), and a velocity ``VolumeData`` (u, v, w at 250³
   × 10 members drawn on the card): the median of 5 CUDA-event times,
   the field dropped from the cache before each; the ensemble mean, DKL
   kNN and residual colour also timed in cumulative parts. (c) The Scene renders
   the DKL kNN and the vorticity field at 1920×1080, its TF changed each
   frame: K2 and K3 once a frame, the frame equal to the direct
   ``dvr_shearwarp`` (1e-6), the median of 5 frames, the peak memory.
   (d) A u/v/w Zarr store written under build/derived (deleted after the
   phase): ``load_volume`` registers the three velocity calculators.
21. BASELINE config 5 through its own entry point on a one-rank NCCL
   mesh at (256, 256, 128) × 64: the sharded Pearson field against
   ``correlate_field`` (K1, 2e-5); each of the four 1280×720 sharded
   frames against ``dvr_shearwarp`` of the same field (max-abs 1e-2, SSIM
   0.995); the launches of the config's own run (K2 and K3 once for
   each of its eight frames, B3 and K1 none, no frame on the gathered
   fallback);
   the NetCDF export (under build/config5, deleted after the phase) read
   back by ``load_volume``, equal to the bit; ``correlate_member_sharded``
   with Spearman, Kendall and KSG at 48³ × 1000, each launching B7, B8 or
   B10 once and equal to ``correlate_field``'s field; the printed
   ``sharded_pearson_ms``, ``batch_render_total_ms`` and
   ``export_bytes``. The process group is destroyed at the end.
22. The sharded isosurface on a one-rank NCCL mesh: the K1 field of a
   planted-box stack at config 5's grid (256×256×128 × 64), 1920×1080,
   intermediate scale 1.0, iso 0.5, a Z-principal and an X-principal
   (resharded) camera, axial supersample 1 and 2: each frame against the
   dense ``iso_shearwarp`` of the same field (premultiplied max-abs
   within the CPU tests' 1e-6 between the two port paths, under JAX's
   cross-package bar 1.5e-2; 0.0 expected on one rank), the median of 5
   frame times (CUDA events) beside the dense frame's median of 5, the
   peak memory.
23. The stress runs on the same one-rank mesh at the sizes of the JAX
   package's ``MULTIGB_r04.json``: ``stress_pearson`` and
   ``stress_reshard`` on a 256×512×512 × 64 bfloat16 stack (8 GiB),
   ``stress_rank_ksg`` with Spearman and Kendall at 64×256×256 × 64 and
   KSG at 32×128×128 × 64: Pearson against its streamed float64
   reference (the port's tests' bar, 2e-6), the reshard's content and the
   rank and KSG fields against the dense ``correlate_field`` (0.0); B7,
   B8 and B10 once each in the timed call; the rows' times and peak
   memory. The process group is destroyed at the end.
24. The multi-host worker: ``multihost_worker.launch(processes=1)``
   starts it as a child process over ``tcp://127.0.0.1`` (NCCL, world
   size 1) on a raw Zarr store at config 5's grid, 128×256×256 × 64
   members in float32 (2 GiB, one chunk a member, under build/multihost,
   deleted after the phase): the child exits 0, its Pearson and Spearman
   against float64 numpy within the tests' bars (1e-5, 1e-4), against
   the one-process K1 field within 1e-5, the reshard exact; the child's
   Spearman launches B7 once and its one-process Pearson K1 once (the
   counts in its evidence JSON); the evidence JSON's load, Pearson and
   reshard times.
25. The decoders at sizes their users read (files under build/decoders,
   deleted after the phase): (a) the ERA5 ensemble on pressure levels as
   the Copernicus CDS serves ``reanalysis-era5-pressure-levels``
   (``ensemble_members``: 10 members × 37 levels × 720×361, 0.5°), one
   GRIB2 file a member written by ``write_grib2`` (16-bit simple
   packing), ``load_volume`` of the 10-file series on the card, each
   member equal to the bit to the numpy decode (the codec's plain
   version), the native codec counted; a Pearson
   ``CorrelationCalculator`` on it and one 1920×1080 Scene frame (K1, K2
   and K3 once each). (b) A 250³ float32 field in .vti (zlib, appended),
   .nii.gz, .cvol and .mhd, each loaded on the card equal to the bit to
   what was written, and one 1920×1080 DVR Scene frame of each (K2 and
   K3 once). The write, decode and upload seconds per format and the
   decode MB/s.
26. The neural correlation calculator (run after phase 20 on phase 17's
   ``VolumeData``). (a) At config 1's grid (128×128×32 × 100), card
   against CPU (one thread) on the same inputs: the training set of 4
   reference points (K1 against its plain version: voxels equal,
   targets within 2e-5); for the frequency (6) and the hash-grid (8
   levels × 2 features, 2^15 table, base 4, scale 1.6) SRN on the same
   carried-over parameters (drawn from one CPU generator) the forward
   on 2^18 samples of the set and ``compute`` over the whole grid
   (2e-5), and 10 paired Adam steps of ``train_srn``'s loss on the same
   batches (each step from the card's parameters on both; 1e-4); MINE
   with P = 16 pairs, n = 200: 50 paired steps of
   ``train_mine_batched``'s loss (each pair's bound before and after the
   step, 1e-4), and the free-running ``train_mine_batched`` of both
   printed beside each other. (b) At the headline (250³ × 100, Pearson)
   for the default SRN (frequency 6, hidden 64, latent 32, 2 + 2 layers,
   ``add_diff``) and the hash-grid SRN, ``train_steps=300``, batch 4096,
   32 reference points: the fit's seconds with its 32 K1 launches and
   their CUDA-event time, the training set's and the step loop's share,
   the final loss; ``compute`` over the grid (median of 5); the Scene's
   point-move frame at 1920×1080 (``set_reference_point``, one MLP pass,
   K2 and K3, no K1), held to the direct call (1e-6), its median of 5
   beside the Pearson calculator's in the same call; the peak memory.
   (c) A reference-format state file naming ``correlation_vmlp`` with an
   ``.npz`` preset (under build/neural, deleted after the phase) loads
   into a Scene on the same ``VolumeData`` and renders; its field equals
   the calculator built directly from the preset, bit for bit.
27. The diagrams (run after phase 26 on phase 17's ``VolumeData``). (a)
   At config 1's grid (128×128×32 × 100, downsample 16: 128 leaves,
   8128 pairs), card against CPU on the same inputs, the CPU's share in
   worker processes of one thread each: ``HEBChart`` with the mean,
   random, halton and plastic samplers in Pearson, mean and plastic in
   Spearman, Kendall, binned MI and KSG (20 samples), and bayesian (40
   samples, screening on): the pair values within the measure's bar and
   the same chords in the same order (pairs tied within the bar may
   trade places); the bayesian pairs where card and CPU take other
   branches of a rounding tie, at most 2% of the refined pairs, each
   between its initial samples and its exhaustive maximum;
   ``correlate_requests`` on 4096 random pairs for the seven measure
   ids; ``field_correlation_matrix``; ``distribution_similarity``'s
   features on 400 points, the t-SNE draw equal to the bit and one step
   within 1e-4 (the embedding after 50 steps and its DBSCAN labels
   printed: ROADMAP C); ``time_series_correlation`` pairwise and lagged.
   (b) At the headline (250³ × 100): the 512-leaf HEB serves of the JAX
   bench (downsample 32, 130,816 pairs, 250 chords), plastic (20
   samples, median of 3 after a warm-up) and bayesian (40, screening
   on; one run after a warm-up); a Scene view of ``dvr`` and each chart
   at 1920×1080: the first frame with its overlay (the chart and its
   SVG, the rasterization, the composite), the point-move frame with
   the cached overlay against the plain frame (median of 5 each), K1, K2
   and K3 once a frame, every overlay rendered (no cache entry
   ``False``), the frames apart only inside the overlay's rectangle, a
   cached frame equal to the first; the field-correlation matrix of two
   fields; ``render_dock`` of two views; the peak memory.
28. TF optimization, the metrics, the mesh and the command line (run
   after phase 27 on phase 17's ``VolumeData``). (a) At config 1's grid
   (128×128×32 × 100), card against CPU on the same inputs, the CPU's
   fits in spawned one-thread workers: field A the K1 Pearson field at
   the first box's centre with the default coolwarm TF over its range,
   field B the Spearman field (B7) there; ``optimize_tf_ols`` with
   cholesky, lu, qr, svd, cgls, lsqr and NNLS (R = 64), the LUTs within
   1e-4 (svd, cgls and lsqr by their voxel loss, 1e-4 relative: the
   system is singular); ``optimize_tf_gd`` (200 epochs); ``optimize_tf_
   diffdvr`` (3 epochs at 64×64, config 1's camera): each epoch's
   gradient at the card's LUT on both (1e-4 relative), the free-running
   LUTs printed; ``lpips_alex`` on the golden weights against the CPU
   (1e-5 relative) and ``tests/goldens/lpips_golden.json`` (1e-4),
   ``lpips_random`` against the CPU; the histogram's counts equal; and
   ``cli.main(["render", ..., "--device", "cuda"])`` on a config-1
   NetCDF written under build/tfopt (deleted after the phase): K1, K2
   and K3 launched, its 1280×720 PNG within the frame bars of the
   ``--device cpu`` PNG. (b) At the headline (250³ × 100): OLS
   (cholesky) and GD (200 epochs) from the Pearson calculator's field A
   to its Spearman field B at R = 64 (median of 3, peak memory);
   DiffDVR on B at 64×64, three epochs timed one by one (host clock), the
   loss before and after, the peak, and 60 × the mean later epoch as the
   estimate of a default fit; ``extract_isosurface`` of A at 0.5; and
   ``run_perf_sweep`` over ``default_perf_states(full=True)``'s 1920×1080
   states on the Pearson field plus an exact ``iso_ray`` state, each
   state's row with its launches.
29. The interactive viewer (run after phase 28 on phase 17's
   ``VolumeData``): ``app/viewer.py``'s server on a free loopback port,
   driven over HTTP as the browser drives it. (a) A server on the card and
   one on the CPU (all its threads) take the scripted session of
   ``tests/test_torch_port_viewer.py`` (every op, its guards and errors,
   the diagrams, the HEB drill-down, state, export, similarity and a TF
   fit; files under build/viewer, deleted after the phase): at config 1's
   grid (128×128×32 × 100, 320×180) with Pearson and Spearman, and at the
   tests' grid (16×16×8 × 16, 96×72) with every measure id (the CPU's
   Kendall and MI fields at config 1's grid take 27-85 s each); replies
   equal but for the timing fields (floats within 1e-4, tied chords may
   trade places), frames within the frame bars. (b) At the headline
   (250³ × 100, 1920×1080, config 1's camera): the point move (POST
   ``pick``, GET ``/frame``; median of 5 after a warm-up) with the
   server's render, overlay and encode split from the ``timing`` op and
   K1, K2 and K3 launched exactly once a move; a cached frame (no launch,
   ``X-Server-Frame-Ms: 0.0``); the viewer's device frame and the Scene's
   point-move frame (CUDA events); ``set_measure spearman`` (B7 once for
   the TF's domain) and its frame (B7, K2, K3 once); an exact frame
   (``fast_dvr`` off: B5 once); ``tf_optimize`` (OLS, R = 64) and the
   frame after it; the peak memory. An HTTP 500 or a launch count off by
   one fails the phase.

The second-to-last line is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import time

import numpy as np
import torch

ATOL_PEARSON = 2e-5  # tests/test_pallas.py:26
ATOL_CLASSIFY = 4e-3  # one bf16 ulp below 1.0 is 3.9e-3
ATOL_COMPOSITE = 3e-3  # tests/test_pallas.py:123-128
# B5 vs its plain version: the same f32 march; the sample value differs
# by FMA contraction (~1e-7), and where that moves a ray's alpha across
# the 0.999 exit the plain version adds one more sample, at most
# (1 − 0.999)·(one sample's alpha) ≤ 7e-5 at voxel step 0.1.
ATOL_RAYMARCH = 1e-4
ATOL_CLASSIFY_VOLUME = 1e-6  # ROADMAP B3: the f32 classify
ATOL_EYE_INSIDE = 1e-4  # the same torch march on the card and the CPU
MAX_ABS_FRAME = 1e-2
MIN_SSIM_FRAME = 0.995
# B7 and B8 against their plain versions: both assemble from exact integer
# sums, so rho agrees to the float32 rounding of one float64 quotient and
# tau exactly.
ATOL_SPEARMAN = 1e-7
ATOL_KENDALL = 0.0
# B9 against its plain version, and B10 against B9 and its plain version:
# equal per-point counts, so the fields differ only by the psi sums'
# rounding (the kernels sum in double, the plain version in f32;
# tests/test_pallas.py:68 holds B9 to JAX at 1e-5).
ATOL_KSG = 1e-5
# A field on the card against the same correlate_field on the CPU, where
# every wrapper runs its plain version (config 2 and 3 sizes): the
# kernels' bars, and for binned MI (torch on both) its einsum's f32 sums.
ATOL_FIELD = {"spearman": ATOL_SPEARMAN, "kendall": 1e-6,
              "mi_binned": 1e-5, "mi_kraskov": ATOL_KSG}

# B6 against its plain version: the same samples and the same rounding
# (every position and sample value that decides a crossing is rounded
# alike), so found masks are equal; the bars are the tests' against the
# TPU kernel. A gradient that touches a NaN voxel carries the 1e30
# sentinel and is compared relative to its size.
ATOL_ISO_T, ATOL_ISO_GRAD, ISO_SENTINEL = 1e-5, 1e-4, 1e20
ATOL_ISO_FRAME = 1e-3  # image where both hit (tests/test_torch_port_iso.py)
# B1 against its plain version: tests/test_pallas.py:442-451 (Σy, Σy²
# 2e-6, Σxy 2e-5, relative and absolute); both sum member after member
# with separate roundings, so they agree to the bit.
TOL_MOMENTS = (2e-6, 2e-6, 2e-5)
ATOL_STREAMED = 1e-5  # pearson_streamed against K1 and a float64 Pearson
# A Scene frame against the direct call on the same inputs: the same
# kernels on the same tensors; a reference-state round trip likewise.
ATOL_SCENE = 1e-6
# The fast iso scan on the card against the CPU on the same rays: both
# sum the tent products in float32 in another order, so a slab value
# rounded to bfloat16 may land one ulp apart and move a crossing within
# its slice (never by a slice, in JAX-vs-port tests a 0.05 slice).
MIN_ISO_SCAN_FOUND_EQUAL = 0.999
MAX_ISO_SCAN_DEPTH = 1.0  # slices
ISO_SCAN_ROWS = 24  # the CPU scans every 24th intermediate row
TIMELAG_STEPS, TIMELAG_LAG, FLY_FRAMES = 40, 2, 8

# Published peaks of one H100 SXM at its full 700 W: HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNELS = {
    "pearson": ("correrender_tpu_torch/ops/cuda/csrc/pearson.cu",
                "correrender_tpu/ops/pallas/pearson_kernel.py:79"),
    "classify_to_cf": ("correrender_tpu_torch/ops/cuda/csrc/classify.cu",
                       "correrender_tpu/ops/pallas/shearwarp_kernel.py:159"),
    "shearwarp_composite": (
        "correrender_tpu_torch/ops/cuda/csrc/shearwarp.cu",
        "correrender_tpu/ops/pallas/shearwarp_kernel.py:237"),
    "raymarch_dvr": ("correrender_tpu_torch/ops/cuda/csrc/raymarch.cu",
                     "correrender_tpu/ops/pallas/raymarch_kernel.py:1125"),
    "classify_volume": ("correrender_tpu_torch/ops/cuda/csrc/classify.cu",
                        "correrender_tpu/ops/pallas/classify_kernel.py:49"),
    "spearman": ("correrender_tpu_torch/ops/cuda/csrc/spearman.cu",
                 "correrender_tpu/ops/pallas/spearman_kernel.py:121"),
    "kendall": ("correrender_tpu_torch/ops/cuda/csrc/kendall.cu",
                "correrender_tpu/ops/pallas/kendall_kernel.py:126"),
    "mi_ksg": ("correrender_tpu_torch/ops/cuda/csrc/ksg.cu",
               "correrender_tpu/ops/pallas/ksg_kernel.py:183"),
    "mi_ksg_banded": ("correrender_tpu_torch/ops/cuda/csrc/ksg_banded.cu",
                      "correrender_tpu/ops/pallas/ksg_banded.py:543"),
    "chunk_moments": ("correrender_tpu_torch/ops/cuda/csrc/moments.cu",
                      "correrender_tpu/ops/pallas/moments_kernel.py:69"),
    "raymarch_iso": ("correrender_tpu_torch/ops/cuda/csrc/raymarch.cu",
                     "correrender_tpu/ops/pallas/raymarch_kernel.py:1267"),
}

# The kernels of the shear-warp frame (phases 4-5).
FAST_PATH = ("pearson", "classify_to_cf", "shearwarp_composite")
HEADLINE_SIDE, HEADLINE_MEMBERS = 250, 100
HEADLINE_IMAGE = (1920, 1080)
EXACT_KERNEL_SIDE, EXACT_KERNEL_IMAGE = 64, (512, 288)
CONFIG1_GRID, CONFIG1_IMAGE = (128, 128, 32), (1280, 720)  # (xs, ys, zs)
MEASURE_KERNEL_N = (37, 250, 1000)
# K1 also at these n (its lane and tiling boundaries: 4 lanes up to 128
# members, 32 above; tiles up to 2048, one warp a voxel above).
K1_EXTRA_N = (1, 2, 3, 4, 5, 37, 100, 128, 129, 1000, 1025, 2048, 2049,
              4096)
# K3's probe variants (csrc/shearwarp.cu) that must give the shipped
# kernel's image to the bit: unpacked rounding, 1 and 4 pixels a
# thread, the exact exit.
K3_EQUAL_TO_SHIPPED = (3, 4, 5, 6)
KENDALL_EXTRA_N = (1, 2, 33, 4096)  # B8 also at these n
# B3 also at these voxel counts (not multiples of a warp's 128-voxel
# chunk, nor of the probe layout's 4 voxels a thread), and its layouts
# (correrender_classify_volume_probe): the shipped warp-strided chunks,
# and 4 consecutive voxels a thread.
B3_EXTRA_N = (1, 3, 5, 15_673)
B3_SHIPPED, B3_QUADS = 0, 1
# B7 also at its lane and register boundaries (8 lanes up to 128 members,
# 32 up to 1024, the shared path above).
SPEARMAN_EXTRA_N = (1, 2, 32, 33, 100, 128, 129, 1024, 1025, 4096)
CONFIG2_GRID, CONFIG2_MEMBERS = (96, 64, 32), 250
CONFIG3_GRID, CONFIG3_MEMBERS = (48, 48, 24), 500
CONFIG_CHECK_STEP = 16  # configs 2-3: every 16th voxel against the CPU
MI_GRID, MI_MEMBERS = 48, 1000  # the JAX bench's KSG size (bench.py:46-47)
# B9 and B10 at their shared-memory limit (_build.MAX_MEMBERS), on
# measure_inputs' correlated, quantized, repeated-member, NaN and
# constant voxels.
KSG_LIMIT_N, KSG_LIMIT_ROWS = 12288, [0, 16, 40, 48, 49]
MI_SUBSET = 4096  # voxels for the plain versions at 48^3 x 1000
GRID_CHECK_STEP = 997  # the 250^3 x 100 fields: every 997th voxel
ISO_VALUE, ISO_VOXEL_STEP = 0.5, 0.25  # the iso frame: q = 4
STREAM_SIDE, STREAM_MEMBERS, STREAM_CHUNK = 250, 1000, 50  # bench.py:43-45
STREAM_CHECK_SIDE = 64  # pearson_streamed against K1 at 64^3 x 1000


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over HBM's rate and the float32 operations over the f32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure_bounds(vs: int, n: int, k: int = 3) -> dict:
    """The least work of B7-B10's functions on ``vs`` voxels of ``n``
    members, whatever the kernel's algorithm: the series read once and
    the (V,) field written; a comparison sort of n members is
    n·log2(n) compare-exchanges of 2 operations."""
    log2n = math.log2(n)
    io_bytes = 4 * vs * n + 4 * n + 4 * vs
    sort_ops = 2.0 * vs * n * log2n
    # KSG: sort y (x is sorted once for all voxels); per point the k+1
    # nearest Chebyshev distances (4 operations each) and the two
    # marginal counts by binary search (2·log2(n) operations each).
    ksg = bound(io_bytes, sort_ops + vs * n * (4.0 * (k + 1) + 4.0 * log2n))
    # B9 (csrc/ksg.cu, estimator 1) scans every ordered pair of a
    # voxel's members for the k-th distance: y_j − y_i, |Δx|, |Δy|, their
    # max and one comparison against the current k-th (5 operations; the
    # x differences are shared by every voxel, so |Δx| counts one); then
    # it sorts y and counts each point's marginals by four binary
    # searches (4·log2(n) steps). At 4096 voxels of 1000 members that is
    # 2.05e10 + 8.2e7 + 1.6e8 operations, 0.31 ms. None is an FMA, which
    # F32_OPS_PER_S counts as two: the card issues at most half of that
    # rate here, so B9 cannot pass about half of this bound.
    full_rows = bound(io_bytes, sort_ops + 5.0 * vs * n * n
                      + 4.0 * vs * n * log2n)
    return {
        # Sort, the tie runs' ranks and the three rank moments (about 8
        # operations a member).
        "spearman": bound(io_bytes, sort_ops + 8.0 * vs * n),
        # Knight's O(n log n) tau-b: a merge sort of y in x's order
        # counting its exchanges, and the tie runs (about 4 operations a
        # member).
        "kendall": bound(io_bytes, sort_ops + 4.0 * vs * n),
        # B10 gives B9's answer by a pruned scan: the function's least
        # work. B9 is held to the full rows it computes.
        "mi_ksg": full_rows,
        "mi_ksg_banded": ksg,
    }


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a − b| over the non-NaN entries (equal infinities count 0);
    NaN must sit in the same places."""
    a = a.float()
    b = b.float()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    assert torch.equal(nan_a, nan_b), "NaN positions differ"
    if bool(nan_a.all()):
        return 0.0
    a, b = a[~nan_a], b[~nan_b]
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


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


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return name, smi


def phase_build() -> None:
    from correrender_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.3f} s")
    entries = ("pearson_tiled_kernel", "pearson_direct_kernel",
               "classify_cf_kernel", "classify_volume_kernel",
               "composite_taps_kernel", "composite_kernel",
               "raymarch_dvr_kernel", "raymarch_iso_kernel",
               "spearman_regs_kernel", "spearman_shared_kernel",
               "kendall_kernel", "ksg_kernel", "ksg_banded_kernel",
               "moments_kernel")
    entry = "?"
    for line in log.splitlines():
        if "entry function" in line:  # ptxas names the kernel first
            entry = next((e for e in entries if e in line), "?")
            # A template instance: its arguments, e.g. ILi8ELi16ELi0E.
            args = re.search(r"kernel(I(?:L[ib]-?\d+E)+)", line)
            entry += f" {args.group(1)}" if args else ""
        elif "registers" in line or "spill" in line:
            print(f"[build] ptxas {entry}: {line.strip()}")


def phase_kernels(dev, errs: dict) -> None:
    from correrender_tpu_torch.ops.cuda.pearson_kernel import (
        pearson_cuda, pearson_plain)
    from correrender_tpu_torch.ops.cuda.shearwarp_kernel import (
        classify_to_cf, classify_to_cf_plain, shearwarp_composite,
        shearwarp_composite_plain)
    from correrender_tpu_torch.ops.pearson import pearson
    from correrender_tpu_torch.render.tf import TransferFunction
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    gen = torch.Generator(device=dev).manual_seed(1)
    # K1 at 64³×100 (a zero-variance voxel included) and unaligned (37, 73).
    stack = synth_box_stack(64, 64, 64, 100, gen, dev)
    stack[3, 4, 5] = 0.0
    rng = np.random.default_rng(0)
    cases = [
        ("64^3x100", stack, stack[32, 32, 16].clone()),
        ("37x73", torch.as_tensor(
            rng.normal(size=(37, 73)).astype(np.float32), device=dev),
         torch.as_tensor(rng.normal(size=73).astype(np.float32), device=dev)),
    ]
    # K1's regimes: n on both sides of the lane width (4 lanes up to 128
    # members, 32 above) and of the tiled limit (2048), V = 2053 (no
    # multiple of any tile), a zero-variance row in each; a stack of 12
    # bytes (no bulk copy), one of 20 (a bulk copy and a tail), and an
    # offset view (not 16-byte aligned: the direct regime).
    for n in K1_EXTRA_N:
        y = torch.randn((2053, n), generator=gen, device=dev)
        y[7] = 0.0
        cases.append((f"{2053}x{n}", y, torch.randn(n, generator=gen,
                                                    device=dev)))
    for v, n in ((1, 3), (5, 1)):
        cases.append((f"{v}x{n}", torch.randn((v, n), generator=gen,
                                              device=dev),
                      torch.randn(n, generator=gen, device=dev)))
    base = torch.randn(2053 * 100 + 1, generator=gen, device=dev)
    view = base[1:].view(2053, 100)
    view[7] = 0.0
    assert view.data_ptr() % 16 == 4
    cases.append(("2053x100 offset view", view, view[11].clone()))
    for label, st, ref in cases:
        got = pearson_cuda(st, ref)
        torch.cuda.synchronize()
        want = pearson_plain(st.reshape(-1, st.shape[-1]), ref).reshape(
            st.shape[:-1])
        err = max_abs(got, want)
        f64 = ""
        if st.shape[-1] >= 4:  # below, |r| is 1 or 0/0 up to cancellation
            r64 = pearson(ref, st, dtype=torch.float64)
            f64 = (f", max|kernel-f64| {max_abs(got, r64):.3e}, "
                   f"max|plain-f64| {max_abs(want, r64):.3e}")
        print(f"[K1 pearson] {label}: max|kernel-plain| {err:.3e} "
              f"(bar {ATOL_PEARSON}){f64}")
        assert err <= ATOL_PEARSON, label
        if st.shape[0] == 2053 and st.shape[1] > 1:
            assert bool(torch.isnan(got[7])), label  # the zero-variance row
        errs["pearson"] = max(errs["pearson"], err)
    assert bool(torch.isnan(pearson_cuda(stack, cases[0][2])[3, 4, 5]))
    del cases, stack, base, view
    # K1 at the headline size on a stack of its own.
    stack = synth_box_stack(HEADLINE_SIDE, HEADLINE_SIDE, HEADLINE_SIDE,
                            HEADLINE_MEMBERS, gen, dev)
    side = HEADLINE_SIDE
    ref = stack[side // 6, side // 3, 2 * side // 3].clone()
    got = pearson_cuda(stack, ref)
    torch.cuda.synchronize()
    err = max_abs(got, pearson_plain(stack.reshape(-1, HEADLINE_MEMBERS),
                                     ref).reshape(got.shape))
    print(f"[K1 pearson] {HEADLINE_SIDE}^3x{HEADLINE_MEMBERS}: "
          f"max|kernel-plain| {err:.3e} (bar {ATOL_PEARSON})")
    assert err <= ATOL_PEARSON
    errs["pearson"] = max(errs["pearson"], err)
    del stack, got

    # K2: NaN, out-of-domain values, a degenerate domain, all orientations.
    field = 1.5 * torch.randn((20, 24, 28), generator=gen, device=dev)
    field[::3, ::5, ::2] = float("nan")
    tf = TransferFunction.from_colormap(
        "viridis", opacity_points=((0.0, 0.1), (1.0, 0.9)), device=dev)
    for domain in ((-1.0, 1.0), (0.0, 0.0)):
        for perm in ((0, 1, 2), (1, 0, 2), (2, 0, 1)):
            for flip in (False, True):
                got = classify_to_cf(field, perm, flip, tf.lut, domain)
                torch.cuda.synchronize()
                want = classify_to_cf_plain(field, perm, flip, tf.lut, domain)
                err = max_abs(got, want)
                assert err <= ATOL_CLASSIFY, (domain, perm, flip, err)
                errs["classify_to_cf"] = max(errs["classify_to_cf"], err)
    print(f"[K2 classify] NaN + degenerate domain, 6 orientations: "
          f"max|kernel-plain| {errs['classify_to_cf']:.3e} "
          f"(bar {ATOL_CLASSIFY})")

    # K3: the tests/test_pallas.py:98-118 setup, with and without kstop,
    # then its boundaries: hi and wi that no tile divides, S = 1, Yv = 1
    # and Xv = 1 (spacing 1), inert slices (g ≤ 1e-6), a slice that the
    # footprint misses, and saturated rays (α reaches exactly 1).
    g20 = np.linspace(1.0, 1.8, 20)
    inert = g20.copy()
    inert[[0, 3, 4, 11]] = (0.0, 1e-6, -0.5, 1e-7)
    missed = g20.copy()
    missed[[5, 6]] = (40.0, -40.0)
    k3_cases = [
        ("20x24x40 -> 48x64", dict()),
        ("20x24x40 -> 48x64, kstop", dict(kstop=True)),
        ("ragged 37x45, kstop", dict(hi=37, wi=45, kstop=True)),
        ("S = 1", dict(s=1, g=np.ones(1))),
        ("Yv = 1", dict(yv=1)),
        ("Xv = 1, kstop", dict(xv=1, kstop=True)),
        ("inert slices", dict(g=inert)),
        ("missed slices", dict(g=missed)),
        ("saturated", dict(attenuation=1e4, opacity=3.0)),
        ("saturated, kstop, ragged 45x70",
         dict(attenuation=1e4, opacity=3.0, kstop=True, hi=45, wi=70)),
    ]
    for label, kw in k3_cases:
        cf, args = composite_case(rng, dev, **kw)
        rgb_k, a_k = shearwarp_composite(cf, **args)
        torch.cuda.synchronize()
        rgb_p, a_p = shearwarp_composite_plain(cf, **args)
        err = max(max_abs(rgb_k, rgb_p), max_abs(a_k, a_p))
        assert err <= ATOL_COMPOSITE, (label, err)
        errs["shearwarp_composite"] = max(errs["shearwarp_composite"], err)
        shipped = torch.cat([rgb_k.reshape(-1), a_k.reshape(-1)])
        probes = {p: composite_probe(cf, args, p) for p in range(1, 7)}
        for p in K3_EQUAL_TO_SHIPPED:
            assert torch.equal(probes[p], shipped), (label, p)
        inline = float((shipped - probes[1]).abs().max())
        fused = float((probes[2] - probes[1]).abs().max())
        print(f"[K3 composite] {label}: max|kernel-plain| {err:.3e} (bar "
              f"{ATOL_COMPOSITE}); max|kernel - inline taps| {inline:.3e}, "
              f"max|q fused - inline taps| {fused:.3e}; alpha = 1 at "
              f"{100 * float((a_k == 1.0).float().mean()):.1f}% of pixels")
        assert inline <= ATOL_COMPOSITE and fused <= ATOL_COMPOSITE, label


def composite_case(rng, dev, s=20, yv=24, xv=40, hi=48, wi=64, g=None,
                   kstop=False, attenuation=80.0, opacity=0.3):
    """K3's inputs in the tests/test_pallas.py:98-118 form: ``(cf,
    keyword arguments of shearwarp_composite)``."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    cf = t(rng.uniform(size=(s, yv, xv, 4)) * 0.3)
    cf[..., 3] *= opacity / 0.3
    args = dict(
        g=t(np.linspace(1.0, 1.8, s) if g is None else g),
        coords_y=t(np.linspace(-0.2, 0.2, yv)),
        coords_x=t(np.linspace(-0.25, 0.25, xv)),
        grid_v=t(np.linspace(-0.22, 0.22, hi)),
        grid_u=t(np.linspace(-0.27, 0.27, wi)),
        eye_uv=(0.05, -0.03),
        len_factor=t(1.0 + 0.2 * rng.uniform(size=(hi, wi))),
        slab_thickness=0.02, attenuation=attenuation,
        kstop=t(rng.uniform(0.0, s, size=(hi, wi))) if kstop else None,
    )
    return cf.to(torch.bfloat16), args


def composite_probe(cf, args, which: int) -> torch.Tensor:
    """One of K3's probe variants on the wrapper's arguments: rgb and
    alpha, flattened and joined."""
    from correrender_tpu_torch.ops.cuda import ablate_fast_path

    rgb, alpha = ablate_fast_path.composite_probe(cf, args, which)
    torch.cuda.synchronize()
    return torch.cat([rgb.reshape(-1), alpha.reshape(-1)])


def smooth_volume(shape, gen, dev) -> torch.Tensor:
    """tests/test_raymarch.py's smoothed normal volume, drawn on ``dev``."""
    vol = torch.randn(shape, generator=gen, device=dev)
    for ax in range(3):
        vol = (vol + vol.roll(1, ax) + vol.roll(-1, ax)) / 3
    return vol


def depth_plane(cam, image_size, dev) -> torch.Tensor:
    """``(H, W)`` eye distances to the plane through the origin that
    faces the camera (+inf where a ray never meets it): a depth buffer
    that clips the volume half way."""
    origin, dirs = cam.rays(*image_size, device=dev)
    n = -origin / origin.norm()
    t = -(origin * n).sum() / (dirs * n).sum(-1)
    return torch.where(t > 0, t, torch.inf)


def rotation_y(deg: float) -> np.ndarray:
    th = np.deg2rad(deg)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                 [-np.sin(th), 0, np.cos(th)]]
    m[:3, 3] = (0.03, -0.02, 0.01)
    return m


def phase_kernels_exact(dev, errs: dict) -> None:
    """B3 and B5 against their plain versions on the card."""
    from correrender_tpu_torch.ops.cuda.raymarch_kernel import (
        dvr_raymarch, dvr_raymarch_plain, plan_raymarch,
        prepare_raymarch_volume)
    from correrender_tpu_torch.render.camera import Camera
    from correrender_tpu_torch.render.classify import (
        classify_volume, classify_volume_plain)
    from correrender_tpu_torch.render.tf import TransferFunction

    gen = torch.Generator(device=dev).manual_seed(2)
    # B3: NaN, ±inf, out-of-domain values and a degenerate domain; voxel
    # counts that leave part of a warp's 128-voxel chunk (and, for the
    # probe layout, 1-3 voxels for its scalar tail), and an offset view (a
    # base 4 bytes past a 16-byte boundary: the probe's scalar loop). The
    # probe layout must give the kernel's output.
    field = 1.5 * torch.randn((20, 24, 28), generator=gen, device=dev)
    field[::3, ::5, ::2] = float("nan")
    field[1, 2, :2] = torch.tensor([float("inf"), -float("inf")])
    lut = torch.rand((256, 4), generator=gen, device=dev)
    gen_b3 = torch.Generator(device=dev).manual_seed(7)
    flat = 1.5 * torch.randn(B3_EXTRA_N[-1] + 1, generator=gen_b3,
                             device=dev)
    flat[::7] = float("nan")
    fields = [("20x24x28", field)] + [
        (f"n = {v}", flat[:v].reshape(1, 1, v)) for v in B3_EXTRA_N] + [
        (f"offset view, n = {B3_EXTRA_N[-1]}",
         flat[1:].view(1, 1, B3_EXTRA_N[-1]))]
    for name, f in fields:
        worst = 0.0
        for domain in ((-1.0, 1.0), (0.0, 0.0)):
            got = classify_volume(f, lut, domain)
            torch.cuda.synchronize()
            err = max_abs(got, classify_volume_plain(f, lut, domain))
            assert err <= ATOL_CLASSIFY_VOLUME, (name, domain, err)
            assert torch.equal(b3_launches(f, lut, domain, B3_QUADS)[1],
                               got), (name, domain)
            worst = max(worst, err)
        errs["classify_volume"] = max(errs["classify_volume"], worst)
        print(f"[B3 classify_volume] {name} (base at {f.data_ptr() % 16} "
              f"bytes past 16), NaN, inf, degenerate domain: "
              f"max|kernel-plain| {worst:.3e} (bar {ATOL_CLASSIFY_VOLUME});"
              f" the probe layout's output equal")

    # B5 at 64³ and 512×288, voxel step 0.1 (q = 10).
    n = EXACT_KERNEL_SIDE
    vol = smooth_volume((n, n, n), gen, dev)
    vol[n // 2, n // 2 - 2, n // 2 + 2] = float("nan")
    lo, hi = (float(v) for v in torch.aminmax(vol[~torch.isnan(vol)]))
    tf = TransferFunction.from_control_points(
        [(0.0, (0.0, 0.2, 1.0)), (0.5, (0.1, 1.0, 0.1)),
         (1.0, (1.0, 0.1, 0.0))],
        [(0.0, 0.0), (0.4, 0.3), (1.0, 0.9)], domain=(lo, hi), device=dev)
    size = EXACT_KERNEL_IMAGE
    near = Camera(position=(0.05, 0.08, 0.9))
    cases = {
        "-z": near,
        "+z": Camera(position=(0.05, 0.08, -0.9)),
        "-x": Camera(position=(0.9, 0.08, 0.05)),
        "+x": Camera(position=(-0.9, 0.08, 0.05)),
        "-y": Camera(position=(0.05, 0.9, 0.08), up=(0.0, 0.0, 1.0)),
        "+y": Camera(position=(0.05, -0.9, 0.08), up=(0.0, 0.0, 1.0)),
    }
    runs = [(name, cam, {}) for name, cam in cases.items()] + [
        ("nan yellow", near, dict(nan_mode="yellow")),
        ("euclidean ball", near,
         dict(restriction=((0.02, -0.01, 0.0), 0.12, "Euclidean"))),
        ("chebyshev ball", near,
         dict(restriction=((0.02, -0.01, 0.0), 0.09, "Chebyshev"))),
        ("depth plane", near, dict(depth_limit=depth_plane(near, size, dev))),
        ("model matrix", near, dict(model_matrix=rotation_y(30.0))),
        ("7 knots", near, dict(tf=TransferFunction.from_colormap(
            "viridis", domain=(lo, hi), device=dev,
            opacity_points=((0.0, 0.1), (0.3, 0.0), (0.8, 0.6))))),
        ("21 knots", near, dict(tf=TransferFunction.from_control_points(
            [(x, (x, 1.0 - x, 0.5 * x)) for x in np.linspace(0.0, 1.0, 11)],
            [(x, 0.5 + 0.4 * np.sin(9.0 * x))
             for x in np.linspace(0.05, 0.95, 10)],
            domain=(lo, hi), device=dev))),
    ]
    for name, cam, kw in runs:
        model = kw.pop("model_matrix", None)
        tf_run = kw.pop("tf", tf)
        plan = plan_raymarch(cam, vol.shape, size, q=10, model_matrix=model)
        prep = prepare_raymarch_volume(vol, plan["axis_world"], plan["flip"],
                                       plan["lane_axis"])
        rgb, a = dvr_raymarch(prep, cam, tf_run, size, plan, **kw)
        torch.cuda.synchronize()
        rgb_p, a_p = dvr_raymarch_plain(prep, cam, tf_run, size, plan, **kw)
        err = max(max_abs(rgb, rgb_p), max_abs(a, a_p))
        print(f"[B5 raymarch_dvr] {name}: max|kernel-plain| {err:.3e} "
              f"(bar {ATOL_RAYMARCH}), mean alpha {float(a.mean()):.4f}")
        assert err <= ATOL_RAYMARCH, name
        assert float(a.max()) > 0.05, name  # the frame is not empty
        errs["raymarch_dvr"] = max(errs["raymarch_dvr"], err)


def phase_config1(dev) -> None:
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_synth_box_pearson_dvr,
        config1_transfer_function)
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.render.pipeline import render_correlation_fast
    from correrender_tpu_torch.utils.fixtures import synth_box_stack
    from correrender_tpu_torch.utils.metrics import ssim

    xs, ys, zs, members = 128, 128, 32, 100
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = synth_box_stack(xs, ys, zs, members, gen, dev)
    cam = config1_camera()
    ref_point = (xs // 4, ys // 4, zs // 2)
    _build.reset_launch_counts()
    img = render_correlation_fast(stack, ref_point, cam,
                                  config1_transfer_function(dev),
                                  image_size=(1280, 720))
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    # The CPU reference runs on one thread: see ROADMAP C for a fault of
    # multi-threaded CPU reductions seen on one host.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    img_plain = render_correlation_fast(
        stack.cpu(), ref_point, cam, config1_transfer_function("cpu"),
        image_size=(1280, 720))
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    a, b = img.cpu().numpy(), img_plain.numpy()
    assert a.shape == (720, 1280, 4) and np.isfinite(a).all()
    err = float(np.abs(a - b).max())
    sim = ssim(a, b)
    print(f"[config1 128x128x32x100 1280x720] kernels vs plain (CPU, "
          f"1 thread, {cpu_s:.1f} s): max-abs {err:.3e} (bar {MAX_ABS_FRAME}), "
          f"SSIM {sim:.6f} (bar {MIN_SSIM_FRAME}), launches {counts}")
    assert err <= MAX_ABS_FRAME and sim >= MIN_SSIM_FRAME
    assert all(counts[k] > 0 for k in FAST_PATH), counts
    res = config1_synth_box_pearson_dvr(device=dev)
    assert torch.isfinite(res["image"]).all()
    print(f"[config1] baseline_configs frame: "
          f"{res['fused_field_plus_render_ms']:.3f} ms (one frame)")


class StageClock:
    """An ``on_stage`` hook for the main path: records a CUDA event as
    each stage is enqueued, and keeps each stage's result."""

    def __init__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        self.marks = []
        self.results = {}

    def __call__(self, name, result):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.marks.append((name, event))
        self.results[name] = result

    def times(self) -> dict:
        """Milliseconds per stage, and the whole frame."""
        torch.cuda.synchronize()
        out, prev = {}, self.start
        for name, event in self.marks:
            out[name] = prev.elapsed_time(event)
            prev = event
        out["frame"] = self.start.elapsed_time(prev)
        return out


def phase_headline(dev, card: str, errs: dict, stack: torch.Tensor):
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.ops.cuda.pearson_kernel import pearson_plain
    from correrender_tpu_torch.ops.cuda.shearwarp_kernel import (
        classify_to_cf_plain, shearwarp_composite_plain)
    from correrender_tpu_torch.render.dvr_fast import composite_inputs
    from correrender_tpu_torch.render.pipeline import (
        reference_series, render_correlation_fast)

    image_size, scale = HEADLINE_IMAGE, 0.75
    side, members = stack.shape[0], stack.shape[-1]
    torch.cuda.reset_peak_memory_stats(dev)
    cam = config1_camera()
    tf = config1_transfer_function(dev)
    ref_point = (side // 4, side // 4, side // 2)

    def frame(on_stage=None):
        return render_correlation_fast(stack, ref_point, cam, tf,
                                       image_size=image_size,
                                       intermediate_scale=scale,
                                       on_stage=on_stage)

    frame()  # warm-up outside the counted run
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    clock = StageClock()
    img = frame(clock)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[headline] main-path launches: {launches}")
    assert all(launches[k] > 0 for k in FAST_PATH), launches
    assert img.shape == image_size[::-1] + (4,)
    assert bool(torch.isfinite(img).all())

    # Each kernel against its plain version on the inputs the main path
    # gave it.
    field = clock.results["field"]
    prepared = clock.results["classify"]
    rgb, alpha, geo = clock.results["composite"]
    cf = prepared["cf"]
    n = stack.shape[-1]
    series = stack.reshape(-1, n)
    ref = reference_series(stack, ref_point)
    field_plain = pearson_plain(series, ref).reshape(field.shape)
    err_field = max_abs(field, field_plain)
    print(f"[headline] field max|kernel-plain| {err_field:.3e} "
          f"(bar {ATOL_PEARSON})")
    assert err_field <= ATOL_PEARSON
    errs["pearson"] = max(errs["pearson"], err_field)
    del field_plain
    flip = prepared["key"][1]
    err_cf = max_abs(cf, classify_to_cf_plain(field, prepared["perm"], flip,
                                              tf.lut, tf.domain))
    print(f"[headline] classify max|kernel-plain| {err_cf:.3e} "
          f"(bar {ATOL_CLASSIFY})")
    assert err_cf <= ATOL_CLASSIFY
    errs["classify_to_cf"] = max(errs["classify_to_cf"], err_cf)
    print(f"[headline] slices {tuple(cf.shape[:3])}, intermediate "
          f"{geo['hi_res']}x{geo['wi_res']}")
    comp_args = composite_inputs(geo, dev)
    rgb_p, alpha_p = shearwarp_composite_plain(cf, **comp_args,
                                               attenuation=100.0)
    err_comp = max(max_abs(rgb, rgb_p), max_abs(alpha, alpha_p))
    probe_args = dict(comp_args, attenuation=100.0)
    shipped = torch.cat([rgb.reshape(-1), alpha.reshape(-1)])
    inline = composite_probe(cf, probe_args, 1)
    fused = composite_probe(cf, probe_args, 2)
    print(f"[headline] composite max|kernel-plain| {err_comp:.3e} "
          f"(bar {ATOL_COMPOSITE}); max|kernel - inline taps| "
          f"{float((shipped - inline).abs().max()):.3e}, max|q fused - inline "
          f"taps| {float((fused - inline).abs().max()):.3e}; alpha = 1 "
          f"at {100 * float((alpha == 1.0).float().mean()):.2f}% of the "
          f"intermediate pixels")
    assert err_comp <= ATOL_COMPOSITE
    errs["shearwarp_composite"] = max(errs["shearwarp_composite"], err_comp)
    del rgb_p, alpha_p, shipped, inline, fused

    # Stage times of the main path (CUDA events at the stage boundaries),
    # median of 5 frames, and each plain version on the same inputs.
    runs = []
    for _ in range(5):
        clock = StageClock()
        frame(clock)
        runs.append(clock.times())
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    med_plain = {
        "field": median_ms(lambda: pearson_plain(series, ref)),
        "classify": median_ms(lambda: classify_to_cf_plain(
            field, prepared["perm"], flip, tf.lut, tf.domain)),
        "composite": median_ms(lambda: shearwarp_composite_plain(
            cf, **comp_args, attenuation=100.0)),
    }
    med_plain["warp"] = med["warp"]  # the same torch code either way
    med_plain["frame"] = sum(med_plain.values())
    notes = {"field": " (K1 Pearson; includes the reference gather)",
             "warp": " (torch bmm, no kernel; plain is the same code)",
             "frame": " (plain: sum of the plain stages)"}
    for stage in ("field", "classify", "composite", "warp", "frame"):
        print(f"[headline {card}] {stage}: kernel {med[stage]:.3f} ms, "
              f"plain {med_plain[stage]:.3f} ms{notes.get(stage, '')}")
    gbs = side**3 * members * 4 / (med["field"] * 1e-3) / 1e9
    print(f"[headline {card}] K1 Pearson reads {side**3 * members * 4 / 1e9:.2f}"
          f" GB: {gbs:.1f} GB/s ({100 * gbs / 3350:.1f}% of 3.35 TB/s)")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[headline {card}] peak max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")
    stage_of = {"pearson": "field", "classify_to_cf": "classify",
                "shearwarp_composite": "composite"}
    vox = field.numel()
    samples = cf.shape[0] * geo["hi_res"] * geo["wi_res"]
    bounds = {
        # K1: the stack read once, the field written; 5 flops a member.
        "pearson": bound(4 * vox * n + 4 * vox + 4 * n, 5 * vox * n),
        # K2: the field read, bf16 RGBA written; about 14 flops a voxel.
        "classify_to_cf": bound(12 * vox + 16 * tf.lut.shape[0], 14 * vox),
        # K3: every slice's bf16 RGBA read once, rgb + alpha written; a
        # bilinear RGBA tap, opacity correction and OVER (about 36 flops)
        # per (intermediate pixel, slice).
        "shearwarp_composite": bound(
            cf.numel() * 2 + 20 * geo["hi_res"] * geo["wi_res"],
            36 * samples),
    }
    stats = {k: (launches[k], med[stage_of[k]], med_plain[stage_of[k]])
             + bounds[k] for k in FAST_PATH}
    return stats, frame


def phase_profile(label: str, frame, groups: dict, required,
                  frames: int = 3) -> None:
    """Device time per kernel group (``{group: kernel-name part}``) under
    ``torch.profiler``, and the device's busy share of the wall time, for
    ``frames`` frames; every group in ``required`` must have run."""
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    totals = dict.fromkeys(list(groups) + ["other torch kernels"], 0.0)
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = event.self_device_time_total / 1e3 / frames
        group = next((g for g, key in groups.items() if key in event.key),
                     "other torch kernels")
        totals[group] += ms
    device_ms = sum(totals.values())
    print(f"[{label}] {frames} frames: wall {wall_ms:.3f} ms/frame, "
          f"device {device_ms:.3f} ms/frame, busy "
          f"{100 * device_ms / wall_ms:.1f}%")
    for group, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"[{label}] {group}: {ms:.3f} ms/frame")
    assert all(totals[g] > 0 for g in required), totals


def phase_exact(dev, card: str, errs: dict, stack: torch.Tensor):
    """Config 1's field rendered by the exact marcher (B5) at 1080p."""
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.ops.cuda.raymarch_kernel import (
        dvr_raymarch, dvr_raymarch_plain, plan_raymarch)
    from correrender_tpu_torch.render.pipeline import reference_series
    from correrender_tpu_torch.render.raymarch_exact import (
        ExactPrepared, _q_from_voxel_step, dvr_render_exact)

    image_size, side = HEADLINE_IMAGE, stack.shape[0]
    torch.cuda.reset_peak_memory_stats(dev)
    cam = config1_camera()
    tf = config1_transfer_function(dev)
    ref_point = (side // 4, side // 4, side // 2)

    def field_of():
        return correlate_field(stack, reference_series(stack, ref_point))

    def frame():
        return dvr_render_exact(field_of(), cam, tf, image_size=image_size,
                                voxel_step=0.1)

    frame()  # warm-up outside the counted run
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    img = frame()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[exact] main-path launches: {launches}")
    assert launches["pearson"] > 0 and launches["raymarch_dvr"] > 0, launches
    assert img.shape == image_size[::-1] + (4,)
    assert bool(torch.isfinite(img).all())

    # B5 against its plain version on the same prepared inputs; the plain
    # march runs 3 times (the first is compared), the kernel 1 + 5.
    field = field_of()
    plan = plan_raymarch(cam, field.shape, image_size)
    plan["q"] = _q_from_voxel_step(plan, 0.1)
    assert plan["q"] == 10, plan["q"]
    prep = ExactPrepared(field).get(plan["axis_world"], plan["flip"],
                                    plan["lane_axis"])
    args = (prep, cam, tf, image_size, plan)
    rgb, a = dvr_raymarch(*args)
    torch.cuda.synchronize()
    plain_times, samples = [], []
    for i in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = dvr_raymarch_plain(*args, samples=samples if i == 0 else None)
        end.record()
        torch.cuda.synchronize()
        plain_times.append(start.elapsed_time(end))
        if i == 0:
            rgb_p, a_p = out
        del out
    err = max(max_abs(rgb, rgb_p), max_abs(a, a_p))
    print(f"[exact] B5 max|kernel-plain| {err:.3e} (bar {ATOL_RAYMARCH}), "
          f"mean alpha {float(a.mean()):.4f}, rays reaching 0.999: "
          f"{100 * float((a >= 0.999).float().mean()):.2f}%")
    assert err <= ATOL_RAYMARCH
    errs["raymarch_dvr"] = max(errs["raymarch_dvr"], err)
    del rgb_p, a_p
    kernel_ms = median_ms(lambda: dvr_raymarch(*args))
    plain_ms = statistics.median(plain_times)
    frame_ms = median_ms(frame)
    prep_ms = median_ms(lambda: ExactPrepared(field).get(
        plan["axis_world"], plan["flip"], plan["lane_axis"]))
    print(f"[exact {card}] {side}^3 field, {image_size[0]}x"
          f"{image_size[1]}, q 10: frame "
          f"{frame_ms:.3f} ms (median of 5: K1 field + layout + B5 + "
          f"epilogue)")
    print(f"[exact {card}] B5 dvr_raymarch {kernel_ms:.3f} ms (median of 5, "
          f"ray setup included), plain {plain_ms:.3f} ms (median of 3); "
          f"prepare_raymarch_volume {prep_ms:.3f} ms")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[exact {card}] peak max_memory_allocated {peak / 2**30:.2f} GiB")
    # B5's bound: the prepared volume read once and the image written; a
    # trilinear sample, the TF's segment, the opacity and OVER (about 50
    # flops) for each sample the rays took (counted by the plain march).
    print(f"[exact {card}] samples taken: {samples[0]} "
          f"({samples[0] / (image_size[0] * image_size[1]):.1f} per ray), "
          f"B5 {samples[0] / kernel_ms * 1e3:.4g} samples/s over the "
          f"wrapper's time (ray setup included)")
    b5_bound = bound(prep.numel() * 4 + 16 * image_size[0] * image_size[1],
                     50 * samples[0])
    return {"raymarch_dvr": (launches["raymarch_dvr"], kernel_ms,
                             plain_ms) + b5_bound}, frame


def phase_restricted(dev, card: str, errs: dict,
                     stack: torch.Tensor) -> dict:
    """The Scene's restricted shear-warp frame at the headline: B3 × a
    restriction ball, with a depth-limit plane (K3's kstop)."""
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.render.camera import default_render_box
    from correrender_tpu_torch.render.classify import (
        classify_volume, classify_volume_plain)
    from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp
    from correrender_tpu_torch.render.pipeline import reference_series
    from correrender_tpu_torch.render.restriction import (
        apply_restriction_rgba, restriction_center, restriction_mask)

    image_size, scale = HEADLINE_IMAGE, 0.75
    shape, side = stack.shape[:3], stack.shape[0]
    cam = config1_camera()
    tf = config1_transfer_function(dev)
    ref_point = (side // 4, side // 4, side // 2)
    box = default_render_box(shape)
    depth = depth_plane(cam, image_size, dev)

    def frame():
        field = correlate_field(stack, reference_series(stack, ref_point))
        center = restriction_center(ref_point, shape, box)
        classified = apply_restriction_rgba(
            classify_volume(field, tf.lut, tf.domain),
            restriction_mask(shape, box, center, 0.1, device=dev))
        return dvr_shearwarp(field, cam, tf, image_size=image_size,
                             intermediate_scale=scale, classified=classified,
                             depth_limit=depth)

    frame()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    img = frame()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[restricted] main-path launches: {launches}")
    assert all(launches[k] > 0 for k in (
        "pearson", "classify_volume", "shearwarp_composite")), launches
    assert launches["classify_to_cf"] == 0  # classified= replaces K2
    assert img.shape == image_size[::-1] + (4,)
    assert bool(torch.isfinite(img).all())

    field = correlate_field(stack, reference_series(stack, ref_point))
    err = max_abs(classify_volume(field, tf.lut, tf.domain),
                  classify_volume_plain(field, tf.lut, tf.domain))
    print(f"[restricted] B3 max|kernel-plain| {err:.3e} "
          f"(bar {ATOL_CLASSIFY_VOLUME})")
    assert err <= ATOL_CLASSIFY_VOLUME
    errs["classify_volume"] = max(errs["classify_volume"], err)
    b3_times, shipped = b3_launches(field, tf.lut, tf.domain, B3_SHIPPED,
                                    reps=21)
    b3_ms = statistics.median(b3_times)
    quad_times, quads = b3_launches(field, tf.lut, tf.domain, B3_QUADS,
                                    reps=21)
    assert torch.equal(quads, shipped)
    del shipped, quads
    wrapper_ms = median_ms(lambda: classify_volume(field, tf.lut, tf.domain))
    b3_plain_ms = median_ms(
        lambda: classify_volume_plain(field, tf.lut, tf.domain))
    frame_ms = median_ms(frame)
    print(f"[restricted {card}] frame {frame_ms:.3f} ms (median of 5: K1 "
          f"field + B3 + mask + layout + K3 with kstop + warp)")
    print(f"[restricted {card}] B3 classify_volume kernel {b3_ms:.4f} ms "
          f"(median of {len(b3_times)} launches into one output, each "
          f"timed alone: min {min(b3_times):.4f}, max {max(b3_times):.4f}),"
          f" wrapper {wrapper_ms:.4f} ms (median of 5: the LUT's "
          f"premultiplication, the output's allocation, the kernel), plain "
          f"{b3_plain_ms:.3f} ms ({side}^3 field -> "
          f"{side**3 * 16 / 1e6:.0f} MB of RGBA)")
    print(f"[restricted {card}] B3 probe, 4 consecutive voxels a thread: "
          f"{statistics.median(quad_times):.4f} ms (median of "
          f"{len(quad_times)}: min {min(quad_times):.4f}, max "
          f"{max(quad_times):.4f}), output equal to the kernel's")
    # B3: the field read, f32 RGBA written; about 14 flops a voxel.
    b3_bound = bound(20 * field.numel() + 16 * tf.lut.shape[0],
                     14 * field.numel())
    return {"classify_volume": (launches["classify_volume"], b3_ms,
                                b3_plain_ms) + b3_bound}


def b3_launches(field, lut, domain, layout: int, reps: int = 0):
    """B3 alone through its probe entry (``layout`` B3_SHIPPED or
    B3_QUADS) on the premultiplied LUT, into one output allocated once:
    one launch, then ``reps`` more, each timed by its own CUDA events.
    Returns (the times in ms, the output). These launches are not
    counted."""
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.render.classify import premultiplied

    lib = _build.library()
    lutp = premultiplied(lut).contiguous()
    out = torch.empty(tuple(field.shape) + (4,), dtype=torch.float32,
                      device=field.device)
    lo, hi = (float(d) for d in domain)

    def launch():
        _build.check(lib.correrender_classify_volume_probe(
            field.data_ptr(), field.numel(), lutp.data_ptr(), lutp.shape[0],
            lo, hi, out.data_ptr(), layout, field.device.index,
            _build.stream_of(out)), "classify_volume_probe")

    launch()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    return times, out


def phase_eye_inside(dev, card: str) -> None:
    """An eye inside the volume: ``render_correlation_fast`` renders it
    with the fixed-step marcher; held to the same march on the CPU."""
    from correrender_tpu_torch.app.baseline_configs import (
        config1_transfer_function)
    from correrender_tpu_torch.render.camera import Camera, default_render_box
    from correrender_tpu_torch.render.dvr import (
        dvr_composite, num_steps_for, world_step_size)
    from correrender_tpu_torch.render.dvr_fast import shearwarp_viable
    from correrender_tpu_torch.render.pipeline import render_correlation_fast
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    (xs, ys, zs), members, rows = CONFIG1_GRID, 100, 24
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = synth_box_stack(xs, ys, zs, members, gen, dev)
    cam = Camera(position=(0.0, 0.0, 0.02), look_at_point=(0.3, 0.1, -1.0))
    tf = config1_transfer_function(dev)
    ref_point, image_size = (xs // 4, ys // 4, zs // 2), CONFIG1_IMAGE
    box = default_render_box((zs, ys, xs))
    assert not shearwarp_viable(cam, box)

    def frame(on_stage=None):
        return render_correlation_fast(stack, ref_point, cam, tf,
                                       image_size=image_size,
                                       on_stage=on_stage)

    stages = {}
    img = frame(stages.__setitem__)
    torch.cuda.synchronize()
    assert list(stages) == ["field"]  # no shear-warp stage ran
    assert img.shape == image_size[::-1] + (4,)
    assert bool(torch.isfinite(img).all())
    frame_ms = median_ms(frame, reps=3)
    step = world_step_size((zs, ys, xs), box[0], box[1], 0.1)
    origin, dirs = cam.rays(*image_size, device=dev)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see ROADMAP C
    t0 = time.perf_counter()
    want = dvr_composite(
        stages["field"].cpu(), origin.cpu(), dirs[::rows].cpu(), box[0],
        box[1], tf.lut.cpu(), tf.domain, step, 100.0, (0.0, 0.0, 0.0, 1.0),
        num_steps_for(box[0], box[1], step))
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    err = max_abs(img[::rows].cpu(), want)
    print(f"[eye inside] {xs}x{ys}x{zs}x{members}, {image_size[0]}x"
          f"{image_size[1]}: max|card-CPU| {err:.3e} "
          f"over every {rows}th row (bar {ATOL_EYE_INSIDE}; CPU 1 thread "
          f"{cpu_s:.1f} s), mean rgb {float(img[..., :3].mean()):.4f}")
    assert err <= ATOL_EYE_INSIDE
    print(f"[eye inside {card}] render_correlation_fast -> dvr_render "
          f"{frame_ms:.3f} ms (median of 3; plain torch, no kernel)")

def time_once(fn) -> float:
    """One CUDA-event timing of ``fn()`` (no warm-up: plain torch)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def measure_inputs(n: int, gen, dev):
    """``(96, n)`` series with correlated voxels, ties (quantized values),
    a repeated member, a NaN voxel and a zero-variance voxel; and two
    reference series, continuous and quantized."""
    x = torch.randn(n, generator=gen, device=dev)
    y = torch.randn((96, n), generator=gen, device=dev)
    y[:16] = 0.8 * x + 0.6 * y[:16]
    y[16:40] = torch.round(y[16:40] * 2.0) / 2.0
    y[40:48, min(5, n - 1)] = y[40:48, min(3, n - 1)]
    y[48, n // 2] = float("nan")
    y[49] = 1.0
    return y, {"continuous": x, "quantized": torch.round(x * 2.0) / 2.0}


def phase_kernels_measures(dev, errs: dict) -> None:
    """B7-B10 against their plain versions, and B10 against B9."""
    from correrender_tpu_torch.ops.cuda.kendall_kernel import (
        kendall_cuda, kendall_plain)
    from correrender_tpu_torch.ops.cuda.ksg_banded import (
        mi_ksg_banded, mi_ksg_banded_plain)
    from correrender_tpu_torch.ops.cuda.ksg_kernel import (
        mi_ksg_cuda, mi_ksg_plain)
    from correrender_tpu_torch.ops.cuda.spearman_kernel import (
        spearman_cuda, spearman_plain)

    gen = torch.Generator(device=dev).manual_seed(4)

    def ksg_cases(y, x, label, use_noise=True):
        for est in (1, 2):
            kw = dict(estimator=est, use_noise=use_noise)
            mi9, c9 = mi_ksg_cuda(y, x, with_counts=True, **kw)
            torch.cuda.synchronize()
            mip, cp = mi_ksg_plain(y, x, with_counts=True, **kw)
            ok = ~torch.isnan(mi9)
            assert torch.equal(c9[ok], cp[ok]), (label, est, "B9 counts")
            err9 = max_abs(mi9, mip)
            assert err9 <= ATOL_KSG, (label, est, err9)
            errs["mi_ksg"] = max(errs["mi_ksg"], err9)
            for w in (192, 16):
                mi10, info = mi_ksg_banded(y, x, w_band=w, with_counts=True,
                                           **kw)
                torch.cuda.synchronize()
                mi10p = mi_ksg_banded_plain(y, x, w_band=w, **kw)
                assert torch.equal(info["counts"][ok], c9[ok]), (
                    label, est, w, "B10 counts")
                err10 = max(max_abs(mi10, mi9), max_abs(mi10, mi10p))
                assert err10 <= ATOL_KSG, (label, est, w, err10)
                errs["mi_ksg_banded"] = max(errs["mi_ksg_banded"], err10)
                print(f"[B9/B10 ksg] {label} est {est} W {w}: counts equal, "
                      f"|B9-plain| {err9:.3e}, |B10-B9|, |B10-plain| "
                      f"<= {err10:.3e} (bar {ATOL_KSG}), B10 points that "
                      f"need one outside the band: "
                      f"{int(info['repaired'].sum())} of {y.numel()}")

    for n in MEASURE_KERNEL_N:
        y, refs = measure_inputs(n, gen, dev)
        for label, x in refs.items():
            case = f"n={n} {label} ref"
            got = spearman_cuda(y, x)
            torch.cuda.synchronize()
            err = max_abs(got, spearman_plain(y, x))
            assert err <= ATOL_SPEARMAN, (case, err)
            assert bool(torch.isnan(got[49])), case  # zero variance
            errs["spearman"] = max(errs["spearman"], err)
            got = kendall_cuda(y, x)
            torch.cuda.synchronize()
            err = max_abs(got, kendall_plain(y, x))
            assert err <= ATOL_KENDALL, (case, err)
            assert bool(torch.isnan(got[48])), case  # the NaN voxel
            ksg_cases(y, x, case)
        print(f"[B7 spearman, B8 kendall] n={n}: max|kernel-plain| "
              f"{errs['spearman']:.3e} (bar {ATOL_SPEARMAN}), "
              f"{errs['kendall']:.3e} (bar {ATOL_KENDALL})")
    # B8 from a single member up, and at n = 4096 (two warps a block).
    for n in KENDALL_EXTRA_N:
        y, refs = measure_inputs(n, gen, dev)
        for label, x in refs.items():
            got = kendall_cuda(y, x)
            torch.cuda.synchronize()
            err = max_abs(got, kendall_plain(y, x))
            assert err <= ATOL_KENDALL, (n, label, err)
            assert bool(torch.isnan(got[48])), (n, label)
            errs["kendall"] = max(errs["kendall"], err)
        print(f"[B8 kendall] n={n}, continuous and quantized ref: "
              f"max|kernel-plain| {errs['kendall']:.3e} (bar {ATOL_KENDALL})")
    # B7 at its boundaries, with three references (continuous,
    # quantized, and quantized with signed zeros and a NaN member) and
    # rows of signed zeros beside measure_inputs' ties and NaN voxel.
    for n in SPEARMAN_EXTRA_N:
        y, refs = measure_inputs(n, gen, dev)
        zeros = torch.round(y[50:56]) * 0.0
        flip = torch.rand(zeros.shape, generator=gen, device=dev) < 0.5
        y[50:56] = torch.where(flip, -zeros, zeros)
        y[56, : (n + 1) // 2] = -0.0
        signed = refs["quantized"].clone()
        signed[(signed == 0) & (torch.arange(n, device=dev) % 2 == 1)] = -0.0
        signed[n // 3] = float("nan")
        refs["signed zeros, NaN"] = signed
        for label, x in refs.items():
            got = spearman_cuda(y, x)
            torch.cuda.synchronize()
            err = max_abs(got, spearman_plain(y, x))
            assert err <= ATOL_SPEARMAN, (n, label, err)
            assert bool(torch.isnan(got[49])), (n, label)  # zero variance
            errs["spearman"] = max(errs["spearman"], err)
        print(f"[B7 spearman] n={n}, {len(refs)} references: "
              f"max|kernel-plain| {errs['spearman']:.3e} "
              f"(bar {ATOL_SPEARMAN})")
    # Mass ties without noise: three levels, whole tie classes at every
    # k-th distance.
    y, refs = measure_inputs(250, gen, dev)
    ksg_cases(torch.clamp(torch.round(y), -1.0, 1.0),
              torch.clamp(torch.round(refs["continuous"]), -1.0, 1.0),
              "n=250 mass ties, no noise", use_noise=False)
    # A mass-tied reference (three levels, no noise) at n = 1000 against
    # measure_inputs' continuous, quantized, NaN and constant voxels.
    y, refs = measure_inputs(1000, gen, dev)
    ksg_cases(y, torch.clamp(torch.round(refs["continuous"]), -1.0, 1.0),
              "n=1000 mass-tied ref, no noise", use_noise=False)
    # The shared-memory limit: a few voxels of _build.MAX_MEMBERS
    # members (one warp a block; B9's rows tile it exactly).
    y, refs = measure_inputs(KSG_LIMIT_N, gen, dev)
    for label, x in refs.items():
        ksg_cases(y[KSG_LIMIT_ROWS].contiguous(), x,
                  f"n={KSG_LIMIT_N} {label} ref")
    # Independent series at n = 1000: B10's longest scans.
    x = torch.randn(1000, generator=gen, device=dev)
    ksg_cases(torch.randn((96, 1000), generator=gen, device=dev), x,
              "n=1000 independent")


def phase_measures_grid(dev, card: str, errs: dict, stack: torch.Tensor,
                        stats: dict) -> None:
    """Spearman, Kendall and KSG fields of the resident 250^3 x 100 stack,
    then a 1080p KSG frame through render_correlation_fast."""
    from correrender_tpu_torch.app.baseline_configs import config1_camera
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.ops.cuda.kendall_kernel import (
        kendall_cuda, kendall_plain)
    from correrender_tpu_torch.ops.cuda.ksg_banded import (
        mi_ksg_banded, mi_ksg_banded_plain)
    from correrender_tpu_torch.ops.cuda.spearman_kernel import (
        spearman_cuda, spearman_plain)
    from correrender_tpu_torch.ops.mi_ksg import (
        maximum_mutual_information_kraskov)
    from correrender_tpu_torch.render.pipeline import (
        reference_series, render_correlation_fast)
    from correrender_tpu_torch.render.tf import TransferFunction

    side, n = stack.shape[0], stack.shape[-1]
    ref_point = (side // 4, side // 4, side // 2)
    ref = reference_series(stack, ref_point)
    series = stack.reshape(-1, n)
    idx = torch.arange(0, series.shape[0], GRID_CHECK_STEP, device=dev)
    sub = series[idx].contiguous()
    bounds = measure_bounds(series.shape[0], n)
    runs = (("spearman", "spearman", spearman_cuda, spearman_plain,
             ATOL_SPEARMAN),
            ("kendall", "kendall", kendall_cuda, kendall_plain, ATOL_KENDALL),
            ("mi_kraskov", "mi_ksg_banded", mi_ksg_banded,
             mi_ksg_banded_plain, ATOL_KSG))
    for measure, kernel, fn, plain, atol in runs:
        correlate_field(stack, ref, measure)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        field = correlate_field(stack, ref, measure)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        assert launches[kernel] > 0, (measure, launches)
        err = max_abs(field.reshape(-1)[idx], plain(sub, ref))
        assert err <= atol, (measure, err)
        errs[kernel] = max(errs[kernel], err)
        ms = median_ms(lambda: correlate_field(stack, ref, measure))
        b_ms, b_by = bounds[kernel]
        print(f"[grid {card}] {side}^3 x {n} {measure}: field {ms:.3f} ms "
              f"(median of 5, {series.shape[0] / ms * 1e3:.4g} voxels/s), "
              f"bound {b_ms:.4f} ms ({b_by}), field/bound {ms / b_ms:.1f}, "
              f"launches {launches[kernel]}; max|kernel-plain| {err:.3e} "
              f"over every {GRID_CHECK_STEP}th voxel (bar {atol})")
        sub_ms = median_ms(lambda: fn(sub, ref))
        plain_ms = time_once(lambda: plain(sub, ref))
        print(f"[table {card}] {kernel} at {side}^3 x {n}: launches "
              f"{launches[kernel]}, field {ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); on every {GRID_CHECK_STEP}th voxel "
              f"({sub.shape[0]}): kernel {sub_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms (one run)")
        stats[f"grid {measure}"] = ms
        del field

    image_size, scale = HEADLINE_IMAGE, 0.75
    cam = config1_camera()
    tf = TransferFunction.from_colormap(
        "viridis", domain=(0.0, maximum_mutual_information_kraskov(3, n)),
        opacity_points=((0.0, 0.0), (1.0, 0.8)), device=dev)

    def frame(on_stage=None):
        return render_correlation_fast(stack, ref_point, cam, tf,
                                       "mi_kraskov", image_size=image_size,
                                       intermediate_scale=scale,
                                       on_stage=on_stage)

    frame()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    img = frame()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[ksg frame] main-path launches: {launches}")
    assert all(launches[k] > 0 for k in (
        "mi_ksg_banded", "classify_to_cf", "shearwarp_composite")), launches
    assert img.shape == image_size[::-1] + (4,)
    assert bool(torch.isfinite(img).all())
    runs = []
    for _ in range(5):
        clock = StageClock()
        frame(clock)
        runs.append(clock.times())
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[ksg frame {card}] {side}^3 x {n}, {image_size[0]}x"
          f"{image_size[1]}: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in med.items())
          + f" (median of 5; field = B10); peak max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")


def phase_configs23(dev, card: str, errs: dict) -> None:
    """BASELINE configs 2 and 3 through their own entry points, with
    counted launches: the very fields they timed, held to
    correlate_field on the CPU (the plain versions) on every 16th voxel,
    and their times (median of 5)."""
    from correrender_tpu_torch.app.baseline_configs import (
        config2_rank_correlations, config3_mutual_information)
    from correrender_tpu_torch.calculators.correlation import (
        correlate_field, nan_bounds)
    from correrender_tpu_torch.ops.cuda import _build

    kernel_of = {"spearman": "spearman", "kendall": "kendall",
                 "mi_kraskov": "mi_ksg_banded", "mi_binned": None}
    ms_key = {"spearman": "spearman_ms", "kendall": "kendall_ms",
              "mi_binned": "binned_ms", "mi_kraskov": "ksg_ms"}
    threads = torch.get_num_threads()
    for config, grid, members in (
            (config2_rank_correlations, CONFIG2_GRID, CONFIG2_MEMBERS),
            (config3_mutual_information, CONFIG3_GRID, CONFIG3_MEMBERS)):
        _build.reset_launch_counts()
        res = config(grid=grid, members=members, device=dev)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        stack, ref = res["stack"], res["ref"]
        n = stack.shape[-1]
        sub = stack.reshape(-1, n)[::CONFIG_CHECK_STEP].cpu()
        # Binned MI's default bounds on the card: the global ranges of
        # the whole ref and stack, as 0-d tensors; the CPU takes the same.
        bounds = tuple((lo.cpu(), hi.cpu())
                       for lo, hi in (nan_bounds(ref), nan_bounds(stack)))
        for measure, field in res["fields"].items():
            kernel = kernel_of[measure]
            if kernel:
                assert launches[kernel] > 0, (res["config"], launches)
            kw = {"mi_bounds": bounds} if measure == "mi_binned" else {}
            torch.set_num_threads(1)  # see ROADMAP C
            try:
                t0 = time.perf_counter()
                want = correlate_field(sub, ref.cpu(), measure, **kw)
                cpu_s = time.perf_counter() - t0
            finally:
                torch.set_num_threads(threads)
            err = max_abs(field.reshape(-1)[::CONFIG_CHECK_STEP].cpu(), want)
            assert err <= ATOL_FIELD[measure], (res["config"], measure, err)
            if kernel:
                errs[kernel] = max(errs[kernel], err)
            ms = res[ms_key[measure]]
            print(f"[{res['config']} {card}] {tuple(stack.shape)} {measure}: "
                  f"field {ms:.3f} ms (median of 5, "
                  f"{stack[..., 0].numel() / ms * 1e3:.4g} voxels/s), "
                  f"launches {launches[kernel] if kernel else 'none (torch)'}"
                  f"; card vs CPU {err:.3e} over every {CONFIG_CHECK_STEP}th"
                  f" voxel (bar {ATOL_FIELD[measure]}; CPU 1 thread "
                  f"{cpu_s:.1f} s)")
        del res, stack, ref


def phase_members(dev, card: str, errs: dict, stats: dict) -> None:
    """48^3 voxels x 1000 members (the JAX bench's KSG size), drawn on the
    card: the Spearman, Kendall and KSG fields through correlate_field
    (B7, B8, B10), each once with counted launches and then its median
    field time; B9 the same way through its own wrapper, which no entry
    point reaches; each kernel against its plain version on a 4096-voxel
    subset, with both times and the bound."""
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.ops.cuda.kendall_kernel import (
        kendall_cuda, kendall_plain)
    from correrender_tpu_torch.ops.cuda.ksg_banded import (
        band_width, mi_ksg_banded, mi_ksg_banded_plain)
    from correrender_tpu_torch.ops.cuda.ksg_kernel import (
        mi_ksg_cuda, mi_ksg_plain)
    from correrender_tpu_torch.ops.cuda.spearman_kernel import (
        spearman_cuda, spearman_plain)

    side, n, k = MI_GRID, MI_MEMBERS, 3
    gen = torch.Generator(device=dev).manual_seed(3)
    stack = torch.randn((side, side, side, n), generator=gen, device=dev)
    ref = stack[side // 2, side // 2, side // 2].clone()
    series = stack.reshape(-1, n)
    sub = series[:MI_SUBSET]
    vs = sub.shape[0]
    kernels = {  # kernel: (correlate_field's measure, wrapper, plain, bar)
        "spearman": ("spearman", spearman_cuda, spearman_plain,
                     ATOL_SPEARMAN),
        "kendall": ("kendall", kendall_cuda, kendall_plain, ATOL_KENDALL),
        "mi_ksg": (None, mi_ksg_cuda, mi_ksg_plain, ATOL_KSG),
        "mi_ksg_banded": ("mi_kraskov", mi_ksg_banded, mi_ksg_banded_plain,
                          ATOL_KSG),
    }
    bounds = measure_bounds(vs, n, k)
    field_bounds = measure_bounds(series.shape[0], n, k)
    for name, (measure, fn, plain, atol) in kernels.items():
        if measure:
            def run(measure=measure):
                return correlate_field(stack, ref, measure)
        else:
            def run(fn=fn):
                return fn(stack, ref)
        run()  # warm-up
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        count = _build.LAUNCHES[name]
        assert count > 0, (name, dict(_build.LAUNCHES))
        full_ms = median_ms(run)
        sub_ms = median_ms(lambda: fn(sub, ref))
        got = fn(sub, ref)
        plain_ms = time_once(lambda: plain(sub, ref))
        err = max_abs(got, plain(sub, ref))
        assert err <= atol, (name, err)
        errs[name] = max(errs[name], err)
        if measure:
            path = f"main path correlate_field(..., {measure!r})"
        else:
            path = "mi_ksg_cuda, not on the main path (B10 scans exactly)"
        # The kernels line counts the main path's launches only.
        stats[name] = ((count if measure else 0), sub_ms, plain_ms) + (
            bounds[name])
        print(f"[members {card}] {side}^3 x {n} {name} through {path}: "
              f"launches {count}, field {full_ms:.3f} ms (median of 5, "
              f"{series.shape[0] / full_ms * 1e3:.4g} voxels/s), field bound "
              f"{field_bounds[name][0]:.4f} ms ({field_bounds[name][1]}); "
              f"{vs}-voxel "
              f"subset: kernel {sub_ms:.3f} ms, plain {plain_ms:.3f} ms (one "
              f"run), bound {bounds[name][0]:.4f} ms ({bounds[name][1]}), "
              f"max|kernel-plain| {err:.3e} (bar {atol})")
    _, info = mi_ksg_banded(sub, ref, with_counts=True)
    left = int(info["repaired"].sum())
    print(f"[members] B10: {left} of {vs * n} points "
          f"({100 * left / (vs * n):.2f}%) need a point outside the rank "
          f"band of W = {band_width(n, k)}")
    ms = median_ms(lambda: correlate_field(stack, ref, "mi_binned"))
    print(f"[members {card}] mi_binned (torch einsum, no kernel) field "
          f"{ms:.3f} ms (median of 5)")


def iso_errors(got, want) -> tuple[float, float]:
    """B6 outputs against their plain version: found masks and the ray
    directions must be equal;
    returns (max |Δt|, max gradient or bracket error) over found rays.
    Values that carry the NaN sentinel must sit in the same places and
    are compared relative to their size."""
    found = want[0]
    assert torch.equal(got[0], found), "found masks differ"
    assert torch.equal(got[5], want[5]), "ray directions differ"
    if not bool(found.any()):
        return 0.0, 0.0
    err_t = max_abs(got[1][found], want[1][found])
    err_g = 0.0
    for ch in (2, 3, 4):
        a, b = got[ch][found], want[ch][found]
        big = b.abs() >= ISO_SENTINEL
        assert torch.equal(a.abs() >= ISO_SENTINEL, big), "sentinel rays differ"
        if bool(big.any()):
            rel = float(((a[big] - b[big]).abs() / b[big].abs()).max())
            assert rel <= 1e-6, ("sentinel gradient", rel)
        if not bool(big.all()):
            err_g = max(err_g, max_abs(a[~big], b[~big]))
    return err_t, err_g


def phase_kernels_iso(dev, errs: dict) -> None:
    """B6 against its plain version on the card."""
    from correrender_tpu_torch.ops.cuda.raymarch_kernel import (
        iso_raymarch, iso_raymarch_plain, plan_raymarch,
        prepare_raymarch_volume)
    from correrender_tpu_torch.render.camera import Camera

    gen = torch.Generator(device=dev).manual_seed(5)
    n = EXACT_KERNEL_SIDE
    vol = smooth_volume((n, n, n), gen, dev)
    vol[n // 2, n // 2 - 2, n // 2 + 2] = float("nan")
    size, iso = EXACT_KERNEL_IMAGE, 0.05
    near = Camera(position=(0.05, 0.08, 0.9))
    cases = {
        "-z": near,
        "+z": Camera(position=(0.05, 0.08, -0.9)),
        "-x": Camera(position=(0.9, 0.08, 0.05)),
        "+x": Camera(position=(-0.9, 0.08, 0.05)),
        "-y": Camera(position=(0.05, 0.9, 0.08), up=(0.0, 0.0, 1.0)),
        "+y": Camera(position=(0.05, -0.9, 0.08), up=(0.0, 0.0, 1.0)),
    }
    # (name, volume, camera, iso value, q, model matrix, image size, the
    # share of rays that hit: its least and its most)
    some = (0.05, 0.95)  # a surface, and rays past it
    runs = [(name, vol, cam, iso, 4, None, size, some)
            for name, cam in cases.items()]
    runs.append(("model matrix", vol, near, iso, 4, rotation_y(30.0), size,
                 some))
    # The ray setup's edge cases: rays along the box's edge x = y = 0.25
    # (an odd width puts the middle column's direction at x = 0 exactly,
    # where the slab test meets 0·inf = NaN), and the eye in the box.
    edge = Camera(position=(0.25, 0.25, 0.9), look_at_point=(0.25, 0.25, 0.0))
    runs.append(("grazing the box's edge", vol, edge, iso, 4, None,
                 (size[0] - 1, size[1] - 1), some))
    runs.append(("eye inside the box", vol, Camera(position=(0.02, 0.03, 0.1)),
                 iso, 4, None, size, (0.5, 1.0)))
    # A ramp over the planes in march order (the near camera flips z):
    # crossings between the first two planes and between the last two.
    ramp = ((n - 1 - torch.arange(n, device=dev, dtype=torch.float32))
            / (n - 1)).reshape(n, 1, 1).expand(n, n, n).contiguous()
    runs.append(("hits in the first slab", ramp, near, 0.5 / (n - 1), 4,
                 None, size, some))
    runs.append(("hits in the last slab", ramp, near, (n - 1.5) / (n - 1), 4,
                 None, size, some))
    runs += [(f"q = {q}", vol, near, iso, q, None, size, some)
             for q in (1, 10)]
    # One or two planes along the march, one voxel across the sub or lane
    # axis; an unsmoothed field, so the thin slabs hold crossings.
    # The box is as thin as a voxel there: few rays meet it, or cross it
    # over more than about a voxel.
    for name, shape in (("planes = 1", (1, n, n)), ("planes = 2", (2, n, n)),
                        ("sub = 1", (n, 1, n)), ("lane = 1", (n, n, 1))):
        thin = torch.randn(shape, generator=gen, device=dev)
        runs.append((name, thin, near, iso, 4, None, size, (0.005, 0.95)))
    for name, volume, cam, iso_value, q, model, image, share in runs:
        plan = plan_raymarch(cam, volume.shape, image, q=q,
                             model_matrix=model)
        prep = prepare_raymarch_volume(volume, plan["axis_world"],
                                       plan["flip"], plan["lane_axis"])
        extents = (plan["planes"], plan["sub_extent"], plan["lane_extent"])
        for refine in (8, 0):
            got = iso_raymarch(prep, cam, iso_value, image, plan,
                               refine_steps=refine)
            torch.cuda.synchronize()
            want = iso_raymarch_plain(prep, cam, iso_value, image, plan,
                                      refine_steps=refine)
            err_t, err_g = iso_errors(got, want)
            hit = float(want[0].float().mean())
            print(f"[B6 raymarch_iso] {name} (planes, sub, lane {extents}, "
                  f"q {q}, {image[0]}x{image[1]}), refine {refine}: found "
                  f"equal ({100 * hit:.2f}% of rays), max|dt| {err_t:.3e} "
                  f"(bar {ATOL_ISO_T}), max|dg| {err_g:.3e} (bar "
                  f"{ATOL_ISO_GRAD}), directions equal")
            assert share[0] <= hit <= share[1], name
            assert err_t <= ATOL_ISO_T and err_g <= ATOL_ISO_GRAD, name
            errs["raymarch_iso"] = max(errs["raymarch_iso"], err_t, err_g)


def moments_errors(got, want) -> float:
    """Max |Δ| of B1's (3, V) sums, asserted within TOL_MOMENTS (relative
    and absolute, per row)."""
    worst = 0.0
    for row, tol in enumerate(TOL_MOMENTS):
        diff = (got[row] - want[row]).abs()
        assert bool((diff <= tol + tol * want[row].abs()).all()), row
        worst = max(worst, float(diff.max()))
    return worst


def phase_kernels_moments(dev, errs: dict) -> None:
    """B1 against its plain version, and pearson_streamed against K1."""
    from correrender_tpu_torch.calculators.correlation import (
        correlate_field, pearson_streamed)
    from correrender_tpu_torch.ops.cuda.moments_kernel import (
        chunk_moments_flat, chunk_moments_plain)

    gen = torch.Generator(device=dev).manual_seed(6)
    for v in (STREAM_SIDE**3, 99_991):
        for e in (STREAM_CHUNK, 13):
            flat = torch.randn((e, v), generator=gen, device=dev)
            ref = torch.randn(e, generator=gen, device=dev)
            acc = torch.randn((3, v), generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                c = flat.to(dtype)
                got = chunk_moments_flat(c, ref)
                torch.cuda.synchronize()
                err = moments_errors(got, chunk_moments_plain(c, ref))
                summed = chunk_moments_flat(c, ref, acc=acc.clone())
                assert torch.equal(summed, acc + got), (v, e, dtype)
                print(f"[B1 chunk_moments] E={e} V={v} {dtype}: "
                      f"max|kernel-plain| {err:.3e} (bars {TOL_MOMENTS}); "
                      f"accumulating form == separate form")
                errs["chunk_moments"] = max(errs["chunk_moments"], err)
                del c, got, summed
            del flat, acc
    side = STREAM_CHECK_SIDE
    stack = torch.randn((side, side, side, STREAM_MEMBERS), generator=gen,
                        device=dev)
    ref = stack[side // 3, side // 2, side // 4].clone()
    members = stack.permute(3, 0, 1, 2).contiguous()  # member-major
    got = pearson_streamed(
        [members[c:c + STREAM_CHUNK]
         for c in range(0, STREAM_MEMBERS, STREAM_CHUNK)], ref)
    err = max_abs(got, correlate_field(stack, ref))
    print(f"[B1 pearson_streamed] {side}^3 x {STREAM_MEMBERS} in "
          f"{STREAM_CHUNK}-member chunks: max|streamed - K1| {err:.3e} "
          f"(bar {ATOL_STREAMED})")
    assert err <= ATOL_STREAMED


def phase_iso_frame(dev, card: str, errs: dict, stack: torch.Tensor):
    """The headline's K1 field through iso_render_exact at 1080p (B6)."""
    from correrender_tpu_torch.app.baseline_configs import config1_camera
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.ops.cuda import raymarch_kernel
    from correrender_tpu_torch.ops.cuda.raymarch_kernel import (
        iso_ray_fields, iso_raymarch, iso_raymarch_plain, plan_raymarch)
    from correrender_tpu_torch.render.camera import Camera
    from correrender_tpu_torch.render.pipeline import reference_series
    from correrender_tpu_torch.render.raymarch_exact import (
        ExactPrepared, _q_from_voxel_step, iso_render_exact,
        shade_from_march)

    image_size, side = HEADLINE_IMAGE, stack.shape[0]
    cam = config1_camera()
    ref_point = (side // 4, side // 4, side // 2)
    field = correlate_field(stack, reference_series(stack, ref_point))
    kw = dict(image_size=image_size, voxel_step=ISO_VOXEL_STEP,
              return_depth=True)

    def frame(on_stage=None, mode="bisection"):
        return iso_render_exact(field, cam, ISO_VALUE, intersection_mode=mode,
                                on_stage=on_stage, **kw)

    frame()  # warm-up outside the counted run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # B6 sets up the rays and hands the shading their directions: no
    # torch ray setup runs in the frame.
    setups = {"_ray_fields": 0, "iso_ray_fields": 0, "Camera.rays": 0}
    patched = [(raymarch_kernel, "_ray_fields"),
               (raymarch_kernel, "iso_ray_fields"), (Camera, "rays")]
    saved = [getattr(owner, attr) for owner, attr in patched]

    def counting(key, fn):
        def counted(*args, **kwargs):
            setups[key] += 1
            return fn(*args, **kwargs)
        return counted

    for (owner, attr), fn, key in zip(patched, saved, setups):
        setattr(owner, attr, counting(key, fn))
    try:
        _build.reset_launch_counts()
        img, depth = frame()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        for (owner, attr), fn in zip(patched, saved):
            setattr(owner, attr, fn)
    print(f"[iso] main-path launches: {launches}; torch ray setups in the "
          f"frame: {setups}")
    assert launches["raymarch_iso"] == 1, launches
    assert not any(setups.values()), setups
    assert img.shape == image_size[::-1] + (4,)
    assert bool(torch.isfinite(img).all())
    hit = torch.isfinite(depth)
    print(f"[iso] {100 * float(hit.float().mean()):.2f}% of the rays hit "
          f"r = {ISO_VALUE}")
    assert 0.01 < float(hit.float().mean()) < 0.99

    plan = plan_raymarch(cam, field.shape, image_size)
    plan["q"] = _q_from_voxel_step(plan, ISO_VOXEL_STEP)
    assert plan["q"] == 4, plan["q"]
    prep = ExactPrepared(field).get(plan["axis_world"], plan["flip"],
                                    plan["lane_axis"])
    args = (prep, cam, ISO_VALUE, image_size, plan)
    out = iso_raymarch(*args)
    torch.cuda.synchronize()
    plain_times, samples = [], []
    for i in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = iso_raymarch_plain(*args, samples=samples if i == 0 else None)
        end.record()
        torch.cuda.synchronize()
        plain_times.append(start.elapsed_time(end))
        if i == 0:
            out_p = res
        del res
    err_t, err_g = iso_errors(out, out_p)
    img_p, depth_p = shade_from_march(out_p, field, cam, ISO_VALUE, plan,
                                      return_depth=True)
    both = torch.isfinite(depth) & torch.isfinite(depth_p)
    assert torch.equal(torch.isfinite(depth), torch.isfinite(depth_p))
    err_img = max_abs(img[both], img_p[both])
    print(f"[iso] B6 max|dt| {err_t:.3e} (bar {ATOL_ISO_T}), max|dg| "
          f"{err_g:.3e} (bar {ATOL_ISO_GRAD}), found equal; frame from the "
          f"plain outputs: max|image| {err_img:.3e} where both hit (bar "
          f"{ATOL_ISO_FRAME})")
    assert err_t <= ATOL_ISO_T and err_g <= ATOL_ISO_GRAD
    assert err_img <= ATOL_ISO_FRAME
    errs["raymarch_iso"] = max(errs["raymarch_iso"], err_t, err_g)
    del out_p, img_p, depth_p

    runs = []
    for _ in range(5):
        clock = StageClock()
        frame(clock)
        runs.append(clock.times())
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    kernel_ms = median_ms(lambda: iso_raymarch(*args))
    rays_ms = median_ms(lambda: iso_ray_fields(cam, image_size, plan, dev))
    plain_ms = statistics.median(plain_times)
    marmitt_ms = median_ms(lambda: frame(mode="marmitt"))
    print(f"[iso {card}] {side}^3 field, {image_size[0]}x{image_size[1]}, "
          f"q 4: frame {med['frame']:.3f} ms (median of 5: layout "
          f"{med['layout']:.3f}, march {med['march']:.3f} (B6 with its ray "
          f"setup),"
          f" shade {med['shade']:.3f})")
    print(f"[iso {card}] B6 iso_raymarch {kernel_ms:.3f} ms (median of 5, "
          f"its ray setup included; the plain version's ray fields in torch "
          f"{rays_ms:.3f} ms), "
          f"plain {plain_ms:.3f} ms (median of 3); marmitt frame (B6 without"
          f" refinement + torch tail) {marmitt_ms:.3f} ms (median of 5)")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[iso {card}] peak max_memory_allocated {peak / 2**30:.2f} GiB")
    # B6's bound: the prepared volume read once, the five outputs and the
    # three direction components written; per pixel about 90 flops of ray
    # setup (the projection, norm and two rotations, the slab test, the
    # five fields); per trilinear sample the rays took (the march up to
    # each hit, 8 + 6 refinement samples per hit, counted by the plain
    # version) about 40 flops: 4 z-lerps and 3 bilinear lerps (3 each),
    # the clamps, floors and fractions, γ, t and the plane coordinates,
    # the sign test.
    pixels = image_size[0] * image_size[1]
    print(f"[iso] samples taken: {samples[0]} ({samples[0] / pixels:.1f} per "
          f"ray)")
    b6_bound = bound(prep.numel() * 4 + 8 * 4 * pixels,
                     40 * samples[0] + 90 * pixels)
    return {"raymarch_iso": (launches["raymarch_iso"], kernel_ms,
                             plain_ms) + b6_bound}, frame


def phase_iso_render(dev, card: str) -> None:
    """iso_render (plain torch) on config 1's field at 1280x720, against
    the same marcher on the CPU."""
    from correrender_tpu_torch.app.baseline_configs import config1_camera
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.render.camera import default_render_box
    from correrender_tpu_torch.render.dvr import num_steps_for, world_step_size
    from correrender_tpu_torch.render.iso import iso_composite, iso_render
    from correrender_tpu_torch.render.pipeline import reference_series
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    (xs, ys, zs), members, rows = CONFIG1_GRID, 100, 24
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = synth_box_stack(xs, ys, zs, members, gen, dev)
    # The reference point at the centre of the first planted box, so that
    # the field has a surface at r = 0.5.
    field = correlate_field(stack, reference_series(
        stack, (zs // 2, zs // 2, zs // 2)))
    cam, image_size = config1_camera(), CONFIG1_IMAGE
    img, depth = iso_render(field, cam, ISO_VALUE, image_size=image_size,
                            return_depth=True)
    torch.cuda.synchronize()
    assert img.shape == image_size[::-1] + (4,)
    assert bool(torch.isfinite(img).all())
    frame_ms = median_ms(lambda: iso_render(field, cam, ISO_VALUE,
                                            image_size=image_size), reps=3)
    box = default_render_box((zs, ys, xs))
    step = world_step_size((zs, ys, xs), box[0], box[1], 0.25)
    origin, dirs = cam.rays(*image_size, device=dev)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see ROADMAP C
    t0 = time.perf_counter()
    img_c, depth_c = iso_composite(
        field.cpu(), origin.cpu(), dirs[::rows].cpu(), box[0], box[1],
        ISO_VALUE, (0.9, 0.4, 0.2, 1.0), step, (0.0, 0.0, 0.0, 1.0),
        num_steps_for(box[0], box[1], step), return_depth=True)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    hit, hit_c = torch.isfinite(depth[::rows].cpu()), torch.isfinite(depth_c)
    agree = float((hit == hit_c).float().mean())
    both = hit & hit_c
    err = max_abs(img[::rows].cpu()[both], img_c[both])
    err_d = max_abs(depth[::rows].cpu()[both], depth_c[both])
    print(f"[iso_render] {xs}x{ys}x{zs}x{members}, {image_size[0]}x"
          f"{image_size[1]}: hit masks agree on {100 * agree:.3f}% of every "
          f"{rows}th row, {100 * float(both.float().mean()):.2f}% hit; "
          f"max|card-CPU| image {err:.3e}, depth {err_d:.3e} where both hit "
          f"(bars 1e-4, 1e-5; CPU 1 thread {cpu_s:.1f} s)")
    assert agree >= 0.999 and float(both.float().mean()) > 0.01
    assert err <= 1e-4 and err_d <= 1e-5
    print(f"[iso_render {card}] {frame_ms:.3f} ms (median of 3; plain torch,"
          f" no kernel)")


def phase_streamed(dev, card: str, errs: dict, stats: dict) -> None:
    """The 250^3 x 1000 Pearson field streamed as bench.py streams it."""
    from correrender_tpu_torch.calculators.correlation import pearson_streamed
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.ops.cuda.moments_kernel import (
        chunk_moments_flat, chunk_moments_plain)
    from correrender_tpu_torch.ops.pearson import pearson

    side, n, e = STREAM_SIDE, STREAM_MEMBERS, STREAM_CHUNK
    nvox = side**3
    gen = torch.Generator(device=dev).manual_seed(7)
    ref = torch.randn(n, generator=gen, device=dev)
    bufs = [torch.randn((e, side, side, side), generator=gen, device=dev)
            for _ in range(2)]
    idx = torch.arange(0, nvox, GRID_CHECK_STEP, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = (x.to(dtype) for x in bufs)
        chunks = [a if c % 2 == 0 else b for c in range(n // e)]
        pearson_streamed(chunks, ref)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        field = pearson_streamed(chunks, ref)
        torch.cuda.synchronize()
        launches = _build.LAUNCHES["chunk_moments"]
        assert launches == n // e, launches
        assert field.shape == (side, side, side)
        assert bool(torch.isfinite(field).all())
        # Every 997th voxel against a float64 Pearson of its 1000 members.
        series = torch.cat([ch.reshape(e, -1)[:, idx] for ch in chunks]).T
        want = pearson(ref.double(), series.double(), dtype=torch.float64)
        err = max_abs(field.reshape(-1)[idx], want)
        assert err <= ATOL_STREAMED, (dtype, err)
        del series, want
        ms = median_ms(lambda: pearson_streamed(chunks, ref))
        gbytes = nvox * n * a.element_size() / 1e9
        bound_ms = gbytes * 1e9 / HBM_BYTES_PER_S * 1e3
        # bench.py's XLA A/B row: three torch calls per chunk.
        acc = torch.zeros((3, nvox), device=dev)

        def three_calls():
            for ch, c0 in zip(chunks, range(0, n, e)):
                c = ch.reshape(e, -1).float()
                acc[0] += c.sum(0)
                acc[1] += (c * c).sum(0)
                acc[2] += ref[c0:c0 + e] @ c

        lib_field_ms = median_ms(three_calls)
        print(f"[streamed {card}] {side}^3 x {n} {dtype}, {n // e} chunks of "
              f"{e}: field {ms:.3f} ms (median of 5), {nvox / ms / 1e6:.3f} "
              f"Gvoxels/s, {gbytes / ms * 1e3:.1f} GB/s effective; launches "
              f"{launches}; max|field - f64| {err:.3e} over every "
              f"{GRID_CHECK_STEP}th voxel (bar {ATOL_STREAMED})")
        print(f"[streamed {card}] {dtype} bound: one read of the stack, "
              f"{nvox} x {n} x {a.element_size()} B = {gbytes:.2f} GB at "
              f"3.35 TB/s = {bound_ms:.3f} ms ({100 * bound_ms / ms:.1f}% of "
              f"it reached); three torch calls per chunk (sum, sum of "
              f"squares, ref @ chunk; bench.py's XLA row) {lib_field_ms:.3f} "
              f"ms per field")
        stats[f"streamed {dtype}"] = ms
        if dtype == torch.float32:
            # The kernels line: one accumulating launch on one chunk.
            flat = a.reshape(e, -1)
            ref_c = ref[:e]
            acc.zero_()
            kernel_ms = median_ms(lambda: chunk_moments_flat(flat, ref_c,
                                                             acc=acc))
            plain_ms = median_ms(lambda: chunk_moments_plain(flat, ref_c,
                                                             acc=acc))

            def lib_chunk():  # one chunk of the three-call formulation
                return flat.sum(0), (flat * flat).sum(0), ref_c @ flat

            lib_ms = median_ms(lib_chunk)
            # The chunk and the running sums read, the sums written.
            b1_bound = bound(4 * e * nvox + 4 * e + 2 * 12 * nvox,
                             5 * e * nvox)
            print(f"[streamed {card}] B1 per chunk ({e} x {side}^3 f32, "
                  f"accumulating): kernel {kernel_ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, three torch calls {lib_ms:.3f} ms, "
                  f"bound {b1_bound[0]:.3f} ms ({b1_bound[1]})")
            stats["chunk_moments"] = (launches, kernel_ms, plain_ms) + (
                b1_bound) + (lib_ms,)
        else:
            # The bfloat16 chunk, as the bf16 field streams it: read as
            # bfloat16, the running sums in float32.
            flat = a.reshape(e, -1)
            ref_c = ref[:e]
            acc.zero_()
            kernel_ms = median_ms(lambda: chunk_moments_flat(flat, ref_c,
                                                             acc=acc))
            b1_bound = bound(2 * e * nvox + 4 * e + 2 * 12 * nvox,
                             5 * e * nvox)
            print(f"[streamed {card}] B1 per chunk ({e} x {side}^3 bf16, "
                  f"accumulating): kernel {kernel_ms:.3f} ms, bound "
                  f"{b1_bound[0]:.3f} ms ({b1_bound[1]}; "
                  f"{100 * b1_bound[0] / kernel_ms:.1f}% of it reached)")
        del a, b, chunks, field, acc
    del bufs


def scene_frame_check(card: str, label: str, render, step, direct,
                      expect=(), forbid=(), frames: int = 5):
    """One Scene interaction: ``step(i)`` makes frame i's change, then
    ``render()`` draws it. Frame 0 warms up; frame 1 is counted and held
    to ``direct()`` (the same call outside the Scene, on the same inputs);
    frames 2.. are timed with CUDA events, the change included. Returns
    (the median ms, the counted launches)."""
    from correrender_tpu_torch.ops.cuda import _build

    step(0)
    render()
    torch.cuda.synchronize()
    step(1)
    _build.reset_launch_counts()
    img = render()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert all(launches.get(k, 0) >= 1 for k in expect), (label, launches)
    assert not any(launches.get(k, 0) for k in forbid), (label, launches)
    assert bool(torch.isfinite(img).all()) and float(img[..., 3].max()) > 0
    err = max_abs(img, direct())
    assert err <= ATOL_SCENE, (label, err)
    times = []
    for i in range(2, 2 + frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(i)
        render()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    print(f"[scene {card}] {label}: frame {ms:.3f} ms (median of {frames}, "
          f"min {min(times):.3f}, max {max(times):.3f}); launches "
          f"{launches}; max|scene - direct| {err:.3e} (bar {ATOL_SCENE})")
    return ms, launches


def iso_scan_rows_cpu(card: str, stages: dict, iso_value: float) -> None:
    """The fast iso scan the card ran (``stages`` from ``on_stage``)
    against the same scan on the CPU, one thread, on every
    ISO_SCAN_ROWS-th intermediate row."""
    from correrender_tpu_torch.render.iso_fast import first_hit_scan

    found, depth, grad, geo = stages["scan"]
    prep = stages["prepare"]
    a, flip, _ = prep["key"]
    in_plane = [i for i in range(3) if i != a]
    rows = torch.arange(0, found.shape[0], ISO_SCAN_ROWS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see ROADMAP C
    t0 = time.perf_counter()
    want = first_hit_scan(
        prep["cvol"].cpu(), geo["g"], geo["coords_v"], geo["coords_u"],
        np.asarray(geo["grid_v"])[rows.numpy()], geo["grid_u"],
        (geo["e_u"], geo["e_v"]), iso_value,
        ip0=in_plane[0], ip1=in_plane[1], ax=a)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    f_card, d_card = found[rows.to(found.device)].cpu(), depth[
        rows.to(found.device)].cpu()
    equal = float((f_card == want[0]).float().mean())
    both = f_card & want[0]
    d_err = float((d_card[both] - want[1][both]).abs().max()) if bool(
        both.any()) else 0.0
    print(f"[scene {card}] fast iso scan, {len(rows)} of {found.shape[0]} "
          f"intermediate rows x {found.shape[1]} on the CPU (1 thread, "
          f"{cpu_s:.1f} s): found equal on {100 * equal:.4f}% (bar "
          f"{100 * MIN_ISO_SCAN_FOUND_EQUAL}%), max|depth card-CPU| "
          f"{d_err:.3e} slices (bar {MAX_ISO_SCAN_DEPTH}), "
          f"{100 * float(f_card.float().mean()):.2f}% of the rays hit")
    assert equal >= MIN_ISO_SCAN_FOUND_EQUAL and d_err <= MAX_ISO_SCAN_DEPTH


def phase_iso_fast_config1(dev, card: str) -> None:
    """The fast iso frame at config 1's size on the card against the same
    function on the CPU (one thread), where it runs the same torch."""
    from correrender_tpu_torch.app.baseline_configs import config1_camera
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.render.iso_fast import iso_shearwarp
    from correrender_tpu_torch.utils.fixtures import synth_box_stack
    from correrender_tpu_torch.utils.metrics import ssim

    (xs, ys, zs), members = CONFIG1_GRID, 100
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = synth_box_stack(xs, ys, zs, members, gen, dev)
    field = correlate_field(stack, stack[zs // 2, ys // 8, xs // 8])
    kw = dict(image_size=CONFIG1_IMAGE, background=(0, 0, 0, 0),
              axial_supersample=2)
    img = iso_shearwarp(field, config1_camera(), ISO_VALUE, **kw)
    ms = median_ms(lambda: iso_shearwarp(field, config1_camera(), ISO_VALUE,
                                         **kw), reps=3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see ROADMAP C
    t0 = time.perf_counter()
    want = iso_shearwarp(field.cpu(), config1_camera(), ISO_VALUE, **kw)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    a, b = img.cpu().numpy(), want.numpy()
    err, sim = float(np.abs(a - b).max()), ssim(a, b)
    cover = float((a[..., 3] > 0).mean())
    print(f"[scene {card}] fast iso at config 1's size ({xs}x{ys}x{zs}, "
          f"{CONFIG1_IMAGE[0]}x{CONFIG1_IMAGE[1]}, axial 2): {ms:.3f} ms "
          f"(median of 3); card vs CPU (1 thread, {cpu_s:.1f} s) max-abs "
          f"{err:.3e} (bar {MAX_ABS_FRAME}), SSIM {sim:.6f} (bar "
          f"{MIN_SSIM_FRAME}), coverage {100 * cover:.2f}%")
    assert err <= MAX_ABS_FRAME and sim >= MIN_SSIM_FRAME and cover > 0.01


def phase_scene(dev, card: str, stack: torch.Tensor) -> None:
    """17. The Scene on the headline stack (see the module docstring)."""
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
    from correrender_tpu_torch.app.state import Scene, _composite
    from correrender_tpu_torch.calculators.correlation import (
        CorrelationCalculator, correlate_field)
    from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
    from correrender_tpu_torch.render.camera import Camera
    from correrender_tpu_torch.render.classify import classify_volume
    from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp
    from correrender_tpu_torch.render.iso_fast import iso_shearwarp
    from correrender_tpu_torch.render.raymarch_exact import (
        ExactPrepared, dvr_render_exact, iso_render_exact)
    from correrender_tpu_torch.render.restriction import (
        apply_restriction_rgba, restriction_center, restriction_mask)
    from correrender_tpu_torch.render.tf import TransferFunction

    side, members = stack.shape[0], stack.shape[-1]
    image_size = HEADLINE_IMAGE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    vd = VolumeData(GridMetadata(xs=side, ys=side, zs=side, es=members),
                    device=dev)
    vd.add_field("q", lambda t, e: stack[..., e])  # one member a slab
    t0 = time.perf_counter()
    mstack = vd.get_member_stack("q")
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"[scene {card}] member stack from {members} member slabs of "
          f"{side}^3: {build_ms:.3f} ms (one build: {members} slab copies "
          f"and torch.stack; host clock, synchronized)")
    cam, cam2 = config1_camera(), Camera(position=(0.08, 0.27, 0.86))
    scene = Scene(vd, [cam])
    p1 = (side // 4, side // 4, side // 2)
    p2 = (side // 4 + 3, side // 4, side // 2)
    calc = CorrelationCalculator(field_name="q", reference_point=p1)
    name = scene.add_calculator(calc)
    scene.transfer_functions[name] = config1_transfer_function(dev)
    box = vd.grid.render_box()
    base = dict(image_size=image_size, box=box, background=(0, 0, 0, 0))

    def render():
        return scene.render_view(0, image_size=image_size)

    def field():
        return vd.get_field(name)

    def tf():
        return scene.tf_for(name)

    def renderers(*nodes):
        scene.renderers = [{"type": t, "view": 0, "field": name, **kw}
                           for t, kw in nodes]

    def no_change(i):
        return None

    renderers(("dvr", {}))
    times = {}
    # (a) The reference point moved.
    times["a"], _ = scene_frame_check(
        card, "(a) reference point moved", render,
        lambda i: calc.set_reference_point(*(p2 if i % 2 else p1)),
        lambda: dvr_shearwarp(correlate_field(mstack, mstack[
            p2[2], p2[1], p2[0]]), cam, tf(), **base),
        expect=FAST_PATH)
    direct_ms = median_ms(lambda: dvr_shearwarp(correlate_field(
        mstack, mstack[p1[2], p1[1], p1[0]]), cam, tf(), **base))
    print(f"[scene {card}] (a) the direct call (correlate_field, then "
          f"dvr_shearwarp at intermediate scale 1.0, as the Scene renders):"
          f" {direct_ms:.3f} ms (median of 5); the Scene adds "
          f"{times['a'] - direct_ms:.3f} ms")
    moves = iter(range(10**6))
    phase_profile(f"profile scene (a) {card}", lambda: (
        calc.set_reference_point(*(p2 if next(moves) % 2 else p1)),
        render()), {
            "K1 pearson_tiled_kernel": "pearson_tiled_kernel",
            "K2 classify_cf_kernel": "classify_cf_kernel",
            "K3 composite_kernel": "composite_kernel",
            "warp bmm (cuBLAS gemm)": "gemm"},
        ("K1 pearson_tiled_kernel", "K3 composite_kernel"))
    # (b) The camera moved within its principal axis.
    times["b"], _ = scene_frame_check(
        card, "(b) camera moved, same principal axis", render,
        lambda i: scene.views.__setitem__(0, cam2 if i % 2 else cam),
        lambda: dvr_shearwarp(field(), cam2, tf(), **base),
        expect=("shearwarp_composite",), forbid=("classify_to_cf",
                                                 "pearson"))

    # (c) The transfer function changed (a new one each frame).
    def new_tf(i):
        scene.transfer_functions[name] = TransferFunction.from_colormap(
            "coolwarm", domain=(-1, 1), device=dev,
            opacity_points=((0.0, 0.8), (0.5, 0.0), (1.0, 0.8 - 0.1 * (
                i % 2))))

    times["c"], _ = scene_frame_check(
        card, "(c) transfer function changed", render, new_tf,
        lambda: dvr_shearwarp(field(), cam, tf(), **base),
        expect=("classify_to_cf", "shearwarp_composite"),
        forbid=("pearson",))
    # (d) Exact quality.
    renderers(("dvr", {"quality": "exact"}))
    times["d"], _ = scene_frame_check(
        card, "(d) dvr quality exact", render, no_change,
        lambda: dvr_render_exact(field(), cam, tf(), **base),
        expect=("raymarch_dvr",), forbid=("shearwarp_composite",))
    # (e) iso_ray, exact and fast.
    iso_kw = dict(base, return_depth=True)
    renderers(("iso_ray", {"iso_value": ISO_VALUE, "quality": "exact"}))
    times["e exact"], _ = scene_frame_check(
        card, "(e) iso_ray exact", render, no_change,
        lambda: iso_render_exact(field(), cam, ISO_VALUE, **iso_kw)[0],
        expect=("raymarch_iso",))
    renderers(("iso_ray", {"iso_value": ISO_VALUE}))
    stages = {}
    times["e fast"], launches = scene_frame_check(
        card, "(e) iso_ray fast (iso_fast: torch, no kernel)", render,
        no_change,
        lambda: iso_shearwarp(field(), cam, ISO_VALUE, axial_supersample=2,
                              on_stage=stages.__setitem__, **iso_kw)[0])
    assert not launches, launches
    iso_scan_rows_cpu(card, stages, ISO_VALUE)
    phase_profile(f"profile scene (e) fast iso {card}", render, {
        "tent products (cuBLAS gemm)": "gemm"},
        ("tent products (cuBLAS gemm)",))
    del stages
    # (f) iso_ray and dvr in one view.
    renderers(("iso_ray", {"iso_value": ISO_VALUE}), ("dvr", {}))

    def merged():
        img, depth = iso_shearwarp(field(), cam, ISO_VALUE,
                                   axial_supersample=2, **iso_kw)
        return _composite(img, dvr_shearwarp(field(), cam, tf(),
                                             depth_limit=depth, **base))

    times["f"], _ = scene_frame_check(
        card, "(f) iso_ray fast + dvr: depth merge, K3 with kstop", render,
        no_change, merged, expect=("shearwarp_composite",))
    # (g) A restricted calculator.
    renderers(("dvr", {}))
    calc.use_render_restriction = True

    def restrict(i):
        calc.render_restriction_radius = 0.12 if i % 2 else 0.1

    def restricted():
        center = restriction_center(calc.reference_point, vd.grid.shape_zyx,
                                    box)
        classified = apply_restriction_rgba(
            classify_volume(field(), tf().lut, tf().domain),
            restriction_mask(field().shape, box, center, 0.12, device=dev))
        return dvr_shearwarp(field(), cam, tf(), classified=classified,
                             **base)

    times["g"], _ = scene_frame_check(
        card, "(g) restricted calculator", render, restrict, restricted,
        expect=("classify_volume", "shearwarp_composite"),
        forbid=("classify_to_cf", "pearson"))
    # (g) iso: a restricted iso_ray frame marches the NaN-filled slab with
    # B6, its layout built for the frame; beside it the same call with
    # the layout built once, which is what a cached layout would save.
    renderers(("iso_ray", {"iso_value": ISO_VALUE}))

    def restricted_slab():
        return Scene._restrict_iso_volume(
            field(), box, scene._active_render_restriction(box))

    times["g iso"], _ = scene_frame_check(
        card, "(g) restricted calculator, iso_ray (B6, layout per frame)",
        render, restrict,
        lambda: iso_render_exact(restricted_slab(), cam, ISO_VALUE,
                                 **iso_kw)[0],
        expect=("raymarch_iso",), forbid=("pearson", "classify_volume"))
    rvol = restricted_slab()
    kept = ExactPrepared(rvol)
    kept_ms = median_ms(lambda: iso_render_exact(rvol, cam, ISO_VALUE,
                                                 prepared=kept, **iso_kw))
    print(f"[scene {card}] (g) iso with its layout built once: "
          f"{kept_ms:.3f} ms (median of 5); building it each frame costs "
          f"the Scene {times['g iso'] - kept_ms:.3f} ms a frame")
    del rvol, kept
    calc.use_render_restriction = False
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[scene {card}] {side}^3 x {members}, {image_size[0]}x"
          f"{image_size[1]}: frames (ms) " + ", ".join(
              f"{k} {v:.3f}" for k, v in times.items())
          + f"; the cache holds {vd.cache.used_bytes / 2**30:.2f} GiB in "
          f"{len(vd.cache)} entries (budget {vd.cache.max_bytes / 2**30:.2f}"
          f" GiB); peak max_memory_allocated {peak / 2**30:.2f} GiB (the "
          f"headline stack the slabs were served from included; the "
          f"member stack alone {mstack.numel() * 4 / 2**30:.2f} GiB)")
    del scene, mstack
    return vd, name


VIEWS_DIR = "build/views"
# Land polygons of the phase-19 shapefile (lon, lat degrees).
VIEWS_RINGS = (
    ((-45, -30), (60, -30), (60, 40), (-45, 40), (-45, -30)),
    ((-160, 10), (-100, 70), (-60, 20), (-120, -50), (-160, 10)),
    ((100, -60), (170, -60), (135, 10), (100, -60)),
)


def write_shapefile(path: str, rings) -> None:
    """A polygon ESRI shapefile (.shp) of one record a ring."""
    import struct

    records = b""
    for i, ring in enumerate(rings):
        content = struct.pack("<i", 5) + struct.pack("<4d", -180, -90, 180,
                                                      90)
        content += struct.pack("<2i", 1, len(ring)) + struct.pack("<i", 0)
        content += b"".join(struct.pack("<2d", x, y) for x, y in ring)
        records += struct.pack(">2i", i + 1, len(content) // 2) + content
    header = struct.pack(">i", 9994) + b"\0" * 20
    header += struct.pack(">i", (100 + len(records)) // 2)
    header += struct.pack("<2i", 1000, 5) + struct.pack(
        "<8d", -180, -90, 180, 90, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(header + records)


#: The phase-19 slices, as Scene renderer settings (the direct calls of
#: phase_views spell them out).
VIEW_SLICES = (dict(axis="z", position=0.5),
               dict(normal_x=1.0, normal_y=1.0, normal_z=1.0,
                    lighting_factor=0.5, nan_handling="yellow",
                    fix_on_ground=True))


def view_renderers(name: str, shapefile=None, overlays: bool = True):
    """The phase-19 view's renderer nodes: dvr, the two slices and the
    outline; with ``overlays`` the world maps (the shapefile's first, if
    given, then the graticule)."""
    nodes = [("dvr", {})] + [("slice", kw) for kw in VIEW_SLICES] + [
        ("domain_outline", {})]
    if overlays:
        nodes += [("world_map", {"shapefile": shapefile})] * bool(
            shapefile) + [("world_map", {})]
    return [{"type": t, "view": 0, **({"field": name} if t in (
        "dvr", "slice") else {}), **kw} for t, kw in nodes]


def median_frames(step, fn, frames: int = 5) -> float:
    """Median of ``frames`` CUDA-event timings of ``step(i); fn()`` after
    a warm-up."""
    step(0)
    fn()
    times = []
    for i in range(1, frames + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(i)
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def views_config1(dev, card: str, shapefile: str) -> None:
    """19 (a): the view at config 1's size, card against CPU."""
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.calculators.correlation import (
        CorrelationCalculator)
    from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.utils.fixtures import synth_box_stack
    from correrender_tpu_torch.utils.metrics import ssim

    (xs, ys, zs), members = CONFIG1_GRID, 100
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = synth_box_stack(xs, ys, zs, members, gen, dev)

    def scene_on(device, st):
        vd = VolumeData(GridMetadata(xs=xs, ys=ys, zs=zs, es=members),
                        device=device)
        vd.add_field("q", lambda t, e: st[..., e])
        scene = Scene(vd, [config1_camera()])
        name = scene.add_calculator(CorrelationCalculator(
            field_name="q", reference_point=(xs // 4, ys // 4, zs // 2)))
        scene.transfer_functions[name] = config1_transfer_function(device)
        scene.renderers = view_renderers(name, shapefile)
        return scene

    kw = dict(image_size=CONFIG1_IMAGE, show_reference_points=True,
              show_legend=True)
    scene = scene_on(dev, stack)
    _build.reset_launch_counts()
    img = scene.render_view(0, **kw)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see ROADMAP C
    t0 = time.perf_counter()
    want = scene_on("cpu", stack.cpu()).render_view(0, **kw)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    a, b = img.cpu().numpy(), want.numpy()
    err, sim = float(np.abs(a - b).max()), ssim(a, b)
    print(f"[views {card}] (a) config 1's size ({xs}x{ys}x{zs} x {members}, "
          f"{CONFIG1_IMAGE[0]}x{CONFIG1_IMAGE[1]}), dvr + 2 slices + outline "
          f"+ 2 world maps + marker + legend: launches {launches}; card vs "
          f"CPU (1 thread, {cpu_s:.1f} s) max-abs {err:.3e} (bar "
          f"{MAX_ABS_FRAME}), SSIM {sim:.6f} (bar {MIN_SSIM_FRAME}), "
          f"coverage {100 * float((a[..., 3] > 0).mean()):.2f}%")
    assert a.shape == (CONFIG1_IMAGE[1], CONFIG1_IMAGE[0], 4)
    assert np.isfinite(a).all() and err <= MAX_ABS_FRAME
    assert sim >= MIN_SSIM_FRAME
    assert all(launches.get(k, 0) == 1 for k in FAST_PATH), launches


def phase_views(dev, card: str, vd, name: str) -> None:
    """19. The Scene's view content (see the module docstring)."""
    import os
    import shutil

    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
    from correrender_tpu_torch.app.state import (
        Scene, _composite, _depth_merge)
    from correrender_tpu_torch.render.camera import Camera
    from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp
    from correrender_tpu_torch.render.legend import blend_legend, legend_patch
    from correrender_tpu_torch.render.outline import outline_render
    from correrender_tpu_torch.render.picking import (
        render_reference_point_marker)
    from correrender_tpu_torch.render.slice_renderer import slice_render_3d
    from correrender_tpu_torch.render.tf import (
        tf_from_xml_string, tf_to_xml_string)
    from correrender_tpu_torch.render.worldmap import (
        graticule_texture, rasterize_shapefile, world_map_render)

    os.makedirs(VIEWS_DIR, exist_ok=True)
    try:
        shapefile = os.path.join(VIEWS_DIR, "land.shp")
        write_shapefile(shapefile, VIEWS_RINGS)
        views_config1(dev, card, shapefile)

        side = vd.grid.xs
        image_size = HEADLINE_IMAGE
        cam, cam2 = config1_camera(), Camera(position=(0.08, 0.27, 0.86))
        scene = Scene(vd, [cam])
        calc = vd.calculators[name]
        scene.transfer_functions[name] = config1_transfer_function(dev)
        box = vd.grid.render_box()
        p1 = (side // 4, side // 4, side // 2)
        p2 = (side // 4 + 3, side // 4, side // 2)
        calc.set_reference_point(*p1)
        host_ms, textures = [], []
        for build in (lambda: rasterize_shapefile(shapefile),
                      graticule_texture):
            t0 = time.perf_counter()
            textures.append(torch.as_tensor(build(), device=dev))
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[views {card}] world-map textures, built and uploaded once "
              f"(the Scene caches them; JAX builds them each frame): "
              f"shapefile {host_ms[0]:.1f} ms, graticule {host_ms[1]:.1f} "
              f"ms (host clock, synchronized)")
        on = dict(show_reference_points=True, show_legend=True)

        def direct(overlays=True):
            """The view without the Scene: the same calls in its order."""
            view_cam, field = scene.views[0], vd.get_field(name)
            tf = scene.tf_for(name)
            kw = dict(image_size=image_size, box=box,
                      background=(0, 0, 0, 0))
            merged, depth = _depth_merge([
                slice_render_3d(field, view_cam, tf, axis="z", position=0.5,
                                return_depth=True, **kw),
                slice_render_3d(field, view_cam, tf, normal=(1.0, 1.0, 1.0),
                                lighting_factor=0.5, nan_handling="yellow",
                                fix_on_ground=True, return_depth=True, **kw),
                outline_render(view_cam, box, image_size=image_size,
                               color=(1, 1, 1, 1), return_depth=True,
                               device=dev)])
            image = None
            for tex in textures if overlays else []:
                image = world_map_render(
                    view_cam, texture=tex, plane_height=float(box[0][1])
                    - 0.01, image_size=image_size, box=box,
                    base_image=image, device=dev)
            image = _composite(_composite(image, merged), dvr_shearwarp(
                field, view_cam, tf, depth_limit=depth, **kw))
            if overlays:
                image = render_reference_point_marker(
                    view_cam, calc.reference_point, vd.grid.shape_zyx, box,
                    image_size=image_size, base_image=image)
                image = blend_legend(image, legend_patch(image_size, tf))
            return image

        def move_point(i):
            calc.set_reference_point(*(p2 if i % 2 else p1))

        def move_camera(i):
            scene.views[0] = cam2 if i % 2 else cam

        cases = {  # label: (renderers, step, overlays, expect, forbid)
            "(h) reference point moved": (
                view_renderers(name, shapefile), move_point, True,
                FAST_PATH, ()),
            "(i) camera moved, same principal axis": (
                view_renderers(name, shapefile), move_camera, True,
                ("shearwarp_composite",), ("pearson", "classify_to_cf")),
            "(j) reference point moved, no marker, legend or maps": (
                view_renderers(name, overlays=False), move_point, False,
                FAST_PATH, ()),
        }
        rows = []
        for label, (nodes, step, overlays, expect, forbid) in cases.items():
            scene.renderers = nodes
            kw = dict(image_size=image_size, **(on if overlays else {}))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ms, launches = scene_frame_check(
                card, f"views (b) {label}",
                lambda kw=kw: scene.render_view(0, **kw), step,
                lambda o=overlays: direct(o), expect=expect, forbid=forbid)
            peak = torch.cuda.max_memory_allocated(dev)
            direct_ms = median_frames(step, lambda o=overlays: direct(o))
            rows.append((label, ms, direct_ms))
            print(f"[views {card}] (b) {label} at {side}^3 x "
                  f"{vd.grid.es}, {image_size[0]}x{image_size[1]}: frame "
                  f"{ms:.3f} ms, the direct call {direct_ms:.3f} ms (medians "
                  f"of 5), the Scene adds {ms - direct_ms:.3f} ms; launches "
                  f"{launches}; peak max_memory_allocated "
                  f"{peak / 2**30:.2f} GiB")
        print(f"[views {card}] (b) the marker, legend and maps cost "
              f"{rows[0][1] - rows[2][1]:.3f} ms a frame ((h) - (j))")
        # Where (h)'s time goes: each part of the direct call alone, on
        # the field of the last frame.
        scene.views[0] = cam
        field, tf = vd.get_field(name), scene.tf_for(name)
        kw = dict(image_size=image_size, box=box, background=(0, 0, 0, 0))
        layers = [
            slice_render_3d(field, cam, tf, axis="z", position=0.5,
                            return_depth=True, **kw),
            slice_render_3d(field, cam, tf, normal=(1.0, 1.0, 1.0),
                            lighting_factor=0.5, nan_handling="yellow",
                            fix_on_ground=True, return_depth=True, **kw),
            outline_render(cam, box, image_size=image_size,
                           color=(1, 1, 1, 1), return_depth=True,
                           device=dev)]
        merged, depth = _depth_merge(layers)
        frame = _composite(merged, dvr_shearwarp(field, cam, tf, **kw))
        patch = legend_patch(image_size, tf)
        parts = {
            "axis slice": lambda: slice_render_3d(
                field, cam, tf, axis="z", position=0.5, return_depth=True,
                **kw),
            "oblique slice": lambda: slice_render_3d(
                field, cam, tf, normal=(1.0, 1.0, 1.0), lighting_factor=0.5,
                nan_handling="yellow", fix_on_ground=True,
                return_depth=True, **kw),
            "outline": lambda: outline_render(
                cam, box, image_size=image_size, color=(1, 1, 1, 1),
                return_depth=True, device=dev),
            "depth merge of 3": lambda: _depth_merge(layers),
            "2 world maps": lambda: world_map_render(
                cam, texture=textures[1], image_size=image_size, box=box,
                plane_height=float(box[0][1]) - 0.01,
                base_image=world_map_render(
                    cam, texture=textures[0], image_size=image_size,
                    box=box, plane_height=float(box[0][1]) - 0.01,
                    device=dev)),
            "marker": lambda: render_reference_point_marker(
                cam, calc.reference_point, vd.grid.shape_zyx, box,
                image_size=image_size, base_image=frame),
            "legend blend": lambda: blend_legend(frame, patch),
            "dvr (K2, K3, warp)": lambda: dvr_shearwarp(field, cam, tf, **kw),
            "dvr, K3 with kstop": lambda: dvr_shearwarp(
                field, cam, tf, depth_limit=depth, **kw),
        }
        print(f"[views {card}] (h)'s parts at {image_size[0]}x"
              f"{image_size[1]} (ms, median of 5 each): " + ", ".join(
                  f"{k} {median_ms(fn):.3f}" for k, fn in parts.items()))
        del layers, merged, depth, frame

        # (c) The reference-state round trip.
        scene.views[0] = cam
        tf = scene.tf_for(name)
        scene.transfer_functions[name] = tf_from_xml_string(
            tf_to_xml_string(tf), tf.domain, device=dev)
        scene.renderers = view_renderers(name)
        kw = dict(image_size=image_size, **on)
        before = scene.render_view(0, **kw)
        path = os.path.join(VIEWS_DIR, "state.json")
        scene.save_state(path, reference_format=True)
        loaded = Scene.load_state(path, volume_data=vd)
        after = loaded.render_view(0, **kw)
        err = max_abs(after, before)
        print(f"[views {card}] (c) reference-state round trip "
              f"({len(scene.renderers)} renderers, {image_size[0]}x"
              f"{image_size[1]}): max|loaded - saved| {err:.3e} (bar "
              f"{ATOL_SCENE})")
        assert err <= ATOL_SCENE and float(after[..., 3].max()) > 0
        assert len(loaded.renderers) == len(scene.renderers)
    finally:
        shutil.rmtree(VIEWS_DIR, ignore_errors=True)


DERIVED_DIR = "build/derived"
CONFIG5_DIR = "build/config5"
VELOCITY_MEMBERS = 10
# Phase 20's bars, card against the CPU on the same inputs: those of
# tests/test_torch_port_calculators.py for the same functions.
TOL_ENSEMBLE = 1e-6  # absolute and relative: float32 sums over members
TOL_DKL_BINNED = 1e-5  # off the bin edges; near them a voxel may move
TOL_DKL_KNN = 2e-6  # plus 8 ulps of max|v| carried through log d_k
TOL_FRACTION = 6e-8  # one ulp of a count over n
TOL_COUNT_RANGE = 1.2e-7
TOL_BLUR = 2e-6  # float32 sums of 2r + 1 taps an axis
TOL_RESIDUAL = 2e-5  # the LUT lerp of an ulp-moved scaled difference
TOL_VELOCITY = 1e-6  # a few ulps of the largest term
TOL_SIMILARITY = {"pearson": 2e-6, "kendall": 1e-6}
SIMILARITY_CPU_SAMPLES = 20_000  # the CPU's Kendall sweep at 4e8 pairs
CONFIG5_IMAGE = (1280, 720)
# Phases 22-25.
ISO_SHARDED_GRID, ISO_SHARDED_MEMBERS = (256, 256, 128), 64  # (X, Y, Z)
ISO_SHARDED_CAMERAS = {"z": (0.05, 0.2, 0.9), "x": (0.9, 0.1, 0.15)}
ISO_SHARDED_VALUE = 0.5
ATOL_ISO_SHARDED = 1.5e-2  # premultiplied; tests/test_dvr_sharded.py
ATOL_ISO_SHARDED_PORT = 1e-6  # sharded vs dense port frame; the CPU tests'
STRESS_PEARSON_GRID = (256, 512, 512)  # (Z, Y, X), MULTIGB_r04.json
STRESS_RANK_GRID, STRESS_KSG_GRID = (64, 256, 256), (32, 128, 128)
STRESS_MEMBERS = 64
ATOL_STRESS_PEARSON = 2e-6  # the port's Pearson bar (tests)
JAX_STRESS_PEARSON = 1.7881393432617188e-07  # MULTIGB_r04.json, 8 GiB
MULTIHOST_DIR = "build/multihost"
MULTIHOST_GRID, MULTIHOST_MEMBERS = (256, 256, 128), 64  # (X, Y, Z)
DECODERS_DIR = "build/decoders"
# ERA5 on pressure levels, ensemble members (Copernicus CDS
# reanalysis-era5-pressure-levels, product_type ensemble_members):
# 10 members, the 37 levels in hPa, the 0.5-degree grid of 720 x 361.
ERA5_MEMBERS, ERA5_GRID = 10, (720, 361)
ERA5_LEVELS = (1000, 975, 950, 925, 900, 875, 850, 825, 800, 775, 750, 700,
               650, 600, 550, 500, 450, 400, 350, 300, 250, 225, 200, 175,
               150, 125, 100, 70, 50, 30, 20, 10, 7, 5, 3, 2, 1)
DECODER_SIDE = 250
# Phase 26.
NEURAL_DIR = "build/neural"
NEURAL_MODELS = {"frequency": {},
                 "hash grid": dict(encoding="hash_grid", hash_levels=8,
                                   hash_features=2, hash_log2_size=15,
                                   hash_base_res=4, hash_per_level_scale=1.6)}
NEURAL_TRAIN_STEPS = 300
NEURAL_REFS = 32
NEURAL_CHECK_REFS = 4  # config 1's training set
NEURAL_CHECK_SAMPLES = 1 << 18
NEURAL_CHECK_STEPS = 10
NEURAL_CHECK_BATCH = 4096
MINE_PAIRS, MINE_SAMPLES, MINE_STEPS = 16, 200, 50
# The SRN forward and field against the CPU: float32 products of another
# summation order (the CPU tests' bar against JAX); a paired Adam step
# and the MINE bound after it (the CPU tests' bar).
ATOL_NEURAL_FORWARD = 2e-5
ATOL_NEURAL_STEP = 1e-4


def analytic_flow(shape_zyx, member: int, members: int, device):
    """u, v, w of a smooth analytic flow on ``shape_zyx``, with a phase
    per member (tests/test_torch_port_calculators.py's ``flow``)."""
    zs, ys, xs = shape_zyx
    z, y, x = (torch.linspace(0, 2 * math.pi, n, device=device)
               for n in (zs, ys, xs))
    z, y, x = z[:, None, None], y[None, :, None], x[None, None, :]
    p = member / members
    shape = (zs, ys, xs)
    return (torch.sin(y + p) * torch.cos(z)).expand(shape),\
        (torch.sin(z + p) * torch.cos(x)).expand(shape),\
        (torch.sin(x + 2 * p) * torch.cos(y)).expand(shape)


def velocity_volume(shape_zyx, members: int, device, draw_on=None):
    """A VolumeData with fields u, v, w (the analytic flow, drawn on
    ``draw_on``, by default ``device``) and the three calculators
    ``load_volume`` registers for them."""
    from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
    from correrender_tpu_torch.io.base import _auto_register_velocity

    zs, ys, xs = shape_zyx
    vd = VolumeData(GridMetadata(xs=xs, ys=ys, zs=zs, es=members),
                    device=device)
    for i, name in enumerate("uvw"):
        vd.add_field(name, lambda t, e, i=i: analytic_flow(
            shape_zyx, e, members, draw_on or device)[i])
    _auto_register_velocity(vd)
    return vd


def derived_calculators(q: str, mean: str, blurred: str):
    """Phase 20's calculators: (label, calculator, bar kind). The
    noise reduction reads ``mean``; the binary operator and the residual
    colour read ``mean`` and ``blurred``."""
    from correrender_tpu_torch.calculators import (
        BinaryOperatorCalculator, DKLCalculator, EnsembleMeanCalculator,
        EnsembleSpreadCalculator, NoiseReductionCalculator,
        ResidualColorCalculator, SetPredicateCalculator)

    return [
        ("ensemble mean", EnsembleMeanCalculator(field_name=q), "ensemble"),
        ("ensemble spread", EnsembleSpreadCalculator(field_name=q),
         "ensemble"),
        ("DKL binned (80 bins)", DKLCalculator(
            field_name=q, estimator="binned", num_bins=80,
            output_name="DKL binned"), "dkl_binned"),
        ("DKL kNN (k = 3)", DKLCalculator(
            field_name=q, estimator="knn", k=3, output_name="DKL kNN"),
         "dkl_knn"),
        ("set predicate, fraction > 0.5", SetPredicateCalculator(
            field_name=q, comparison="greater", aggregation="fraction",
            threshold=0.5, output_name="fraction"), "fraction"),
        ("set predicate, count range [20, 60] of > 0.5",
         SetPredicateCalculator(
             field_name=q, comparison=">", aggregation="count_range",
             threshold=0.5, count_lower=20, count_upper=60,
             output_name="count range"), "count_range"),
        ("noise reduction (sigma 1) of the mean", NoiseReductionCalculator(
            field_name=mean, sigma=1.0, output_name="blurred"), "blur"),
        ("binary operator: mean - its blur", BinaryOperatorCalculator(
            field_name_a=mean, field_name_b=blurred, operator="difference",
            output_name="mean - blurred"), "exact"),
        ("residual colour: mean - its blur", ResidualColorCalculator(
            field_name_a=mean, field_name_b=blurred,
            output_name="residual"), "residual"),
    ]


def dkl_edge_voxels(stack: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Voxels with a sample within 8 float32 ulps of a bin edge, in a
    float64 evaluation of ``dkl_binned``'s bin positions."""
    v = stack.reshape(-1, stack.shape[-1]).double()
    m = v.mean(-1, keepdim=True)
    vn = (v - m) / ((m - v) ** 2).mean(-1, keepdim=True).sqrt()
    lo = vn.amin(-1, keepdim=True) - 0.01
    hi = vn.amax(-1, keepdim=True) + 0.01
    pos = (vn - lo) * num_bins / (hi - lo)
    return ((pos - pos.round()).abs()
            < 8 * 2.0 ** -24 * pos.clamp_min(1)).any(-1)


def dkl_knn_bar(stack: torch.Tensor, k: int) -> torch.Tensor:
    """TOL_DKL_KNN plus 8 ulps of max|v| carried through log d_k, a voxel
    (float64)."""
    from correrender_tpu_torch.ops.dkl import kth_neighbour_distance

    v = stack.reshape(-1, stack.shape[-1]).double()
    m = v.mean(-1, keepdim=True)
    vn = (v - m) / ((m - v) ** 2).mean(-1, keepdim=True).sqrt()
    dk = kth_neighbour_distance(torch.sort(vn, dim=-1).values, k)
    cond = (vn.abs().amax(-1, keepdim=True) / dk).mean(-1) * 2.0 ** -24
    return TOL_DKL_KNN + 8 * cond


def field_error(kind: str, got: torch.Tensor, want: torch.Tensor,
                stack: torch.Tensor) -> str:
    """Hold a card field to the CPU's at its kind's bar; a summary."""
    got = got.cpu()
    if kind in ("ensemble", "blur", "exact", "residual", "fraction",
                "count_range", "velocity"):
        bar = {"ensemble": TOL_ENSEMBLE, "blur": TOL_BLUR, "exact": 0.0,
               "residual": TOL_RESIDUAL, "fraction": TOL_FRACTION,
               "count_range": TOL_COUNT_RANGE,
               "velocity": TOL_VELOCITY}[kind]
        err = max_abs(got, want)
        rel = TOL_ENSEMBLE * float(want[~torch.isnan(want)].abs().max()) \
            if kind == "ensemble" else 0.0
        assert err <= bar + rel, (kind, err, bar + rel)
        return f"max-abs {err:.3e} (bar {bar + rel:.1e})"
    if kind == "dkl_binned":
        diff = (got - want).abs().reshape(-1)
        near = dkl_edge_voxels(stack, 80)
        moved = int((diff > TOL_DKL_BINNED).sum())
        far = float(diff[~near].max())
        assert far <= TOL_DKL_BINNED and moved <= int(near.sum()), (
            far, moved, int(near.sum()))
        return (f"max-abs off the edges {far:.3e} (bar {TOL_DKL_BINNED}); "
                f"{moved} voxels moved a bin, {int(near.sum())} near an edge")
    assert kind == "dkl_knn", kind
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got.reshape(-1), want.reshape(-1)
    ok = ~nan.reshape(-1)
    bar = dkl_knn_bar(stack.reshape(-1, stack.shape[-1])[ok], 3)
    ratio = float(((g[ok] - w[ok]).abs() / bar).max())
    assert ratio <= 1.0, ratio
    return (f"NaN (ties) in {int(nan.sum())} voxels on both; worst "
            f"|diff| / bar {ratio:.3f}")


def derived_config1(dev, card: str) -> None:
    """20 (a): every derived field at config 1's grid, card against the
    CPU (one thread) on the same inputs."""
    from correrender_tpu_torch.calculators import (
        EnsembleSpreadCalculator)
    from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
    from correrender_tpu_torch.ops.similarity import field_similarity
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    (xs, ys, zs), members = CONFIG1_GRID, 100
    gen = torch.Generator(device=dev).manual_seed(5)
    stack = synth_box_stack(xs, ys, zs, members, gen, dev)
    host = stack.cpu()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see ROADMAP C
    t0 = time.perf_counter()
    try:
        grid = GridMetadata(xs=xs, ys=ys, zs=zs, es=members)
        card_vd = VolumeData(grid, device=dev)
        card_vd.add_field("q", lambda t, e: stack[..., e])
        cpu_vd = VolumeData(grid, device="cpu")
        cpu_vd.add_field("q", lambda t, e: host[..., e])
        calcs = derived_calculators("q", "Ensemble Mean (q)", "blurred")
        for _, calc, _ in calcs:
            card_vd.add_calculator(calc)
        # The CPU side reads the card's mean and blur where a field is
        # computed from them, so each field is held on the same inputs.
        mean = card_vd.get_field("Ensemble Mean (q)").cpu()
        blurred = card_vd.get_field("blurred").cpu()
        cpu_vd.add_field("m", lambda t, e: mean)
        cpu_vd.add_field("b", lambda t, e: blurred)
        for (label, calc, kind), (_, twin, _) in zip(
                calcs, derived_calculators("q", "m", "b")):
            cpu_vd.add_calculator(twin)
            got = card_vd.get_field(calc.output_name)
            want = cpu_vd.get_field(twin.output_name)
            assert got.shape == want.shape
            print(f"[derived {card}] (a) {label}: card vs CPU "
                  f"{field_error(kind, got, want, host)}")
        spread = card_vd.get_field("Ensemble Spread (q)").cpu()
        for measure, bar in TOL_SIMILARITY.items():
            kw = dict(measure=measure, max_samples=SIMILARITY_CPU_SAMPLES)
            got = field_similarity(mean.to(dev), spread.to(dev), **kw)
            want = field_similarity(mean, spread, **kw)
            print(f"[derived {card}] (a) field similarity {measure} (mean, "
                  f"spread; {SIMILARITY_CPU_SAMPLES} samples): card "
                  f"{got:.7f}, CPU {want:.7f} (bar {bar})")
            assert abs(got - want) <= bar
        # The velocity family on the same host-drawn flow.
        vshape = (zs, ys, xs)
        card_v = velocity_volume(vshape, VELOCITY_MEMBERS, dev, "cpu")
        cpu_v = velocity_volume(vshape, VELOCITY_MEMBERS, "cpu")
        for vd in (card_v, cpu_v):
            vd.add_calculator(EnsembleSpreadCalculator(field_name="Helicity"))
        for name, kind in (("Vector Magnitude", "velocity"),
                           ("Vorticity", "velocity"),
                           ("Helicity", "velocity"),
                           ("Ensemble Spread (Helicity)", "velocity")):
            got, want = card_v.get_field(name, 0, 3), cpu_v.get_field(
                name, 0, 3)
            print(f"[derived {card}] (a) {name}: card vs CPU "
                  f"{field_error(kind, got, want, host)}")
    finally:
        torch.set_num_threads(threads)
    print(f"[derived {card}] (a) config 1's grid ({xs}x{ys}x{zs} x "
          f"{members}; velocity x {VELOCITY_MEMBERS}): every field held, "
          f"{time.perf_counter() - t0:.1f} s with the CPU on one thread")


def field_ms(vd, name: str, *drop) -> float:
    """Median of 5 CUDA-event times of ``vd.get_field(name)``, the field
    (and ``drop``) dropped from the cache before each run."""
    def run():
        for n in (name,) + drop:
            vd.cache.invalidate_field(n)
        return vd.get_field(name)

    return median_ms(run)


def derived_frames(card: str, vd, name: str, label: str) -> float:
    """The Scene's 1080p DVR frame of a derived field, its TF changed
    each frame (K2 and K3 once a frame), held to the direct call."""
    from correrender_tpu_torch.app.baseline_configs import config1_camera
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp
    from correrender_tpu_torch.render.tf import TransferFunction

    cam = config1_camera()
    scene = Scene(vd, [cam])
    scene.add_renderer("dvr", field=name)
    lo, hi = vd.get_min_max(name)
    box = vd.grid.render_box()

    def new_tf(i):
        scene.transfer_functions[name] = TransferFunction.from_colormap(
            "coolwarm", domain=(lo, hi), device=vd.device,
            opacity_points=((0.0, 0.0), (1.0, 0.9 - 0.1 * (i % 2))))

    ms, launches = scene_frame_check(
        card, f"(c) {label}: transfer function changed", lambda: (
            scene.render_view(0, image_size=HEADLINE_IMAGE)),
        new_tf, lambda: dvr_shearwarp(
            vd.get_field(name), cam, scene.tf_for(name),
            image_size=HEADLINE_IMAGE, box=box, background=(0, 0, 0, 0)),
        expect=("classify_to_cf", "shearwarp_composite"),
        forbid=("pearson",))
    assert launches["classify_to_cf"] == 1 == launches[
        "shearwarp_composite"], launches
    return ms


def derived_parts(card: str, vd, residual) -> None:
    """20 (b) split: the ensemble mean, DKL kNN and residual colour timed
    in cumulative parts on the headline's inputs (CUDA-event medians), to
    show where their time goes."""
    from correrender_tpu_torch.calculators.base import stack_slabs
    from correrender_tpu_torch.ops.dkl import (
        _normalize, dkl_knn, kth_neighbour_distance)
    from correrender_tpu_torch.render.tf import TransferFunction

    stack = vd.get_member_stack("q", 0)
    n = stack.shape[-1]
    mean, blurred = vd.get_field("Ensemble Mean (q)"), vd.get_field("blurred")

    def over_slabs(fn):
        def run():  # each slab's result dropped before the next slab
            for _, slab in stack_slabs(stack):
                fn(slab.reshape(-1, n))
        return run

    def sorted_vn(s):
        return torch.sort(_normalize(s), dim=-1).values

    def residual_upto(step):
        def run():  # ResidualColorCalculator.compute, cut after ``step``
            diff = mean - blurred
            mag = diff.abs()
            bound = torch.clamp_min(torch.where(
                torch.isnan(mag), -torch.inf, mag).amax(), 1e-30)
            if step == "bound":
                return bound
            tf = TransferFunction.from_colormap(
                "coolwarm", domain=(-1.0, 1.0), device=diff.device)
            return tf if step == "tf" else tf(diff / bound)
        return run

    parts = {
        "mean: sum": over_slabs(lambda s: s.sum(-1)),
        "mean: mean": over_slabs(lambda s: s.mean(-1)),
        "mean: nanmean": over_slabs(lambda s: torch.nanmean(s, dim=-1)),
        "kNN: normalize": over_slabs(_normalize),
        "kNN: + sort": over_slabs(sorted_vn),
        "kNN: + k-th distance": over_slabs(
            lambda s: kth_neighbour_distance(sorted_vn(s), 3)),
        "kNN: dkl_knn": over_slabs(lambda s: dkl_knn(s, 3)),
        "residual: diff and bound": residual_upto("bound"),
        "residual: + TF built": residual_upto("tf"),
        "residual: + lookup": residual_upto("lookup"),
        "residual: compute()": lambda: residual.compute(0, 0),
    }
    print(f"[derived {card}] (b) parts (ms, cumulative within a group, "
          f"median of 5): " + ", ".join(
              f"{k} {median_ms(fn):.3f}" for k, fn in parts.items()))


def phase_derived(dev, card: str, vd) -> None:
    """20. The derived-field calculators (see the module docstring)."""
    import os
    import shutil

    from correrender_tpu_torch.app.baseline_configs import write_zarr_array
    from correrender_tpu_torch.calculators import EnsembleSpreadCalculator
    from correrender_tpu_torch.io import load_volume
    from correrender_tpu_torch.ops.similarity import field_similarity

    derived_config1(dev, card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    side, members = vd.grid.xs, vd.grid.es
    calcs = derived_calculators("q", "Ensemble Mean (q)", "blurred")
    for _, calc, _ in calcs:
        vd.add_calculator(calc)
    times = {}
    for label, calc, _ in calcs:
        field = vd.get_field(calc.output_name)
        assert bool(torch.isfinite(field).any()), label
        times[label] = field_ms(vd, calc.output_name)
    mean = vd.get_field("Ensemble Mean (q)")
    spread = vd.get_field("Ensemble Spread (q)")
    for measure in TOL_SIMILARITY:
        value = field_similarity(mean, spread, measure)
        times[f"field similarity {measure}"] = median_ms(
            lambda: field_similarity(mean, spread, measure), reps=3)
        assert math.isfinite(value), measure
        print(f"[derived {card}] field similarity {measure} (mean, spread)"
              f" = {value:.6f}")
    print(f"[derived {card}] (b) {side}^3 x {members} fields (ms, median of "
          f"5 with the field dropped from the cache before each; the member "
          f"stack resident): " + ", ".join(
              f"{k} {v:.3f}" for k, v in times.items()))
    derived_parts(card, vd, next(calc for label, calc, _ in calcs
                                 if label.startswith("residual")))

    # The velocity VolumeData: u, v, w at the headline's grid, drawn on
    # the card.
    vel = velocity_volume((side, side, side), VELOCITY_MEMBERS, dev)
    vel.add_calculator(EnsembleSpreadCalculator(field_name="Helicity"))
    vtimes = {}
    for name in ("Vector Magnitude", "Vorticity", "Helicity"):
        assert bool(torch.isfinite(vel.get_field(name)).all()), name
        vtimes[name] = field_ms(vel, name)
    spread_h = "Ensemble Spread (Helicity)"
    assert bool(torch.isfinite(vel.get_field(spread_h)).all())
    vtimes[spread_h + ", stack resident"] = field_ms(vel, spread_h)
    vtimes[spread_h + ", helicity recomputed"] = field_ms(
        vel, spread_h, "Helicity")
    print(f"[derived {card}] (b) velocity {side}^3 x {VELOCITY_MEMBERS} "
          f"members (u, v, w drawn on the card; ms, median of 5): "
          + ", ".join(f"{k} {v:.3f}" for k, v in vtimes.items()))

    # (c) The Scene renders the DKL and the vorticity field.
    frames = {"DKL kNN": derived_frames(card, vd, "DKL kNN", "DKL kNN"),
              "Vorticity": derived_frames(card, vel, "Vorticity",
                                          "vorticity")}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[derived {card}] (c) Scene frames at {HEADLINE_IMAGE[0]}x"
          f"{HEADLINE_IMAGE[1]} (ms): " + ", ".join(
              f"{k} {v:.3f}" for k, v in frames.items())
          + f"; peak max_memory_allocated {peak / 2**30:.2f} GiB (the "
          f"headline stack and phase 17's cache included)")

    # (d) load_volume registers the velocity calculators of a u/v/w file.
    os.makedirs(DERIVED_DIR, exist_ok=True)
    try:
        store = os.path.join(DERIVED_DIR, "wind.zarr")
        for i, name in enumerate("uvw"):
            data = np.stack([analytic_flow((16, 24, 32), e, 2, "cpu")[i]
                             .numpy() for e in range(2)])[:, None]
            write_zarr_array(os.path.join(store, name), data,
                             (1, 1, 16, 24, 32))
        loaded = load_volume(store, device=dev)
        names = sorted(loaded.calculators)
        assert names == ["Helicity", "Vector Magnitude", "Vorticity"], names
        for name in names:
            assert bool(torch.isfinite(loaded.get_field(name, 0, 1)).all())
        print(f"[derived {card}] (d) load_volume of a u/v/w Zarr store "
              f"registered {names}")
    finally:
        shutil.rmtree(DERIVED_DIR, ignore_errors=True)
    for _, calc, _ in calcs:
        vd.remove_calculator(calc.output_name)


def phase_config5(dev, card: str) -> None:
    """21. BASELINE config 5 (see the module docstring)."""
    import os
    import shutil

    import torch.distributed as dist

    from correrender_tpu_torch.app.baseline_configs import (
        config5_sharded_batch_render, config5_stack)
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.io import load_volume
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.parallel import (
        correlate_member_sharded, dvr_sharded, shard_member_stack)
    from correrender_tpu_torch.parallel.mesh import shard_member_series
    from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp
    from correrender_tpu_torch.utils.metrics import ssim

    # The sharded DVR's one fallback, the gathered dense frame of an
    # eye-inside camera, launches the same two kernels: count its calls
    # to show that every frame of the run took the sharded route.
    gathered = dvr_sharded.dvr_shearwarp
    fallbacks = []

    def counted_fallback(*args, **kwargs):
        fallbacks.append(1)
        return gathered(*args, **kwargs)

    os.makedirs(CONFIG5_DIR, exist_ok=True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        dvr_sharded.dvr_shearwarp = counted_fallback
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = config5_sharded_batch_render(tmp_dir=CONFIG5_DIR)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dvr_sharded.dvr_shearwarp = gathered
        # The config's own run: 8 sharded frames (warm-up and timed
        # pass), each K2 then K3 once; the Pearson field is torch moments
        # (no kernel), and nothing classifies with B3.
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        n_frames = 2 * res["batch_renders"]
        print(f"[config5 {card}] launches of config5_sharded_batch_render "
              f"({n_frames} frames): {launches}; gathered fallbacks "
              f"{len(fallbacks)}")
        assert launches == {"classify_to_cf": n_frames,
                            "shearwarp_composite": n_frames}, launches
        assert not fallbacks, "a config-5 frame took the gathered route"
        assert dist.get_backend() == "nccl" and res["devices"] == 1
        mesh, field, tf = res["mesh"], res["field"], res["tf"]
        stack, ref = res["stack"], res["ref"]
        want = correlate_field(stack, ref)
        err = max_abs(field, want)
        print(f"[config5 {card}] grid {res['grid']} x {res['members']} on "
              f"{res['devices']} NCCL rank: sharded_pearson_ms "
              f"{res['sharded_pearson_ms']:.3f}, batch_render_total_ms "
              f"{res['batch_render_total_ms']:.3f} ({res['batch_renders']} "
              f"frames at {CONFIG5_IMAGE[0]}x{CONFIG5_IMAGE[1]}), "
              f"export_bytes {res['export_bytes']}, the config {wall:.1f} s;"
              f" field vs correlate_field (K1) {err:.3e} (bar "
              f"{ATOL_PEARSON})")
        assert err <= ATOL_PEARSON
        for i, (cam, frame) in enumerate(zip(res["cameras"], res["frames"])):
            direct = dvr_shearwarp(field, cam, tf, image_size=CONFIG5_IMAGE,
                                   intermediate_scale=0.5)
            a, b = frame.cpu().numpy(), direct.cpu().numpy()
            diff, sim = float(np.abs(a - b).max()), ssim(a, b)
            print(f"[config5 {card}] frame {i}: vs dvr_shearwarp max-abs "
                  f"{diff:.3e} (bar {MAX_ABS_FRAME}), SSIM {sim:.6f} (bar "
                  f"{MIN_SSIM_FRAME})")
            assert diff <= MAX_ABS_FRAME and sim >= MIN_SSIM_FRAME
        loaded = load_volume(res["export_path"], device=dev)
        back = loaded.get_field("pearson")
        assert torch.equal(back, field), "the export differs"
        print(f"[config5 {card}] the NetCDF export read back by load_volume:"
              f" equal to the bit ({res['export_bytes']} bytes)")
        peak = torch.cuda.max_memory_allocated(dev)
        del res, stack, field, want, loaded, back

        # The gathered measures at 48^3 x 1000 (launch counters reset
        # around each call).
        grid = (MI_GRID, MI_GRID, MI_GRID)
        st = config5_stack(grid, MI_MEMBERS, (0, MI_GRID), dev)
        r = torch.as_tensor(np.random.default_rng(3).normal(
            size=MI_MEMBERS).astype(np.float32), device=dev)
        block = shard_member_stack(st, mesh)
        ref_block = shard_member_series(r, mesh)
        for measure, kernel in (("spearman", "spearman"),
                                ("kendall", "kendall"),
                                ("mi_kraskov", "mi_ksg_banded")):
            _build.reset_launch_counts()
            got = correlate_member_sharded(block, ref_block, mesh, measure)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            assert launches == {kernel: 1}, (measure, launches)
            err = max_abs(got, correlate_field(st, r, measure))
            ms = median_ms(lambda: correlate_member_sharded(
                block, ref_block, mesh, measure), reps=3)
            print(f"[config5 {card}] correlate_member_sharded {measure} at "
                  f"{MI_GRID}^3 x {MI_MEMBERS}: {ms:.3f} ms (median of 3), "
                  f"launches {launches}, vs correlate_field {err:.3e}")
            assert err == 0.0
        print(f"[config5 {card}] peak max_memory_allocated "
              f"{peak / 2**30:.2f} GiB (config 5's run)")
    finally:
        dvr_sharded.dvr_shearwarp = gathered
        shutil.rmtree(CONFIG5_DIR, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_timelag(dev, card: str, errs: dict) -> None:
    """18. Config 4, then a time-lag store at the headline's grid."""
    import shutil
    from pathlib import Path

    from correrender_tpu_torch.app import camera_path
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function,
        config4_timelag_zarr_flythrough, write_zarr_array)
    from correrender_tpu_torch.app.camera_path import (
        orbit_path, render_flythrough)
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.calculators.correlation import (
        CorrelationCalculator)
    from correrender_tpu_torch.io import load_volume
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.ops.pearson import pearson
    from correrender_tpu_torch.utils.fixtures import synth_box_stack
    from correrender_tpu_torch.utils.metrics import ssim

    root = Path(__file__).resolve().parent / "build" / "timelag"
    shutil.rmtree(root, ignore_errors=True)
    write_png = camera_path.write_png
    try:
        # Config 4 at its own size, on the card and on the CPU.
        res = config4_timelag_zarr_flythrough(str(root / "c4"), device=dev)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # see ROADMAP C
        res_cpu = config4_timelag_zarr_flythrough(str(root / "c4_cpu"),
                                                  device="cpu")
        torch.set_num_threads(threads)
        worst, least = 0.0, 1.0
        for i, cam in enumerate(res["cameras"]):
            t = res["times"][i % len(res["times"])]
            imgs = []
            for scene in (res["scene"], res_cpu["scene"]):
                scene.views[0], scene.current_time = cam, t
                imgs.append(scene.render_view(0, image_size=(320, 240))
                            .cpu().numpy())
            worst = max(worst, float(np.abs(imgs[0] - imgs[1]).max()))
            least = min(least, ssim(imgs[0], imgs[1]))
        scene = res["scene"]
        scene.current_time = len(res["times"])  # a time not yet computed
        _build.reset_launch_counts()
        scene.render_view(0, image_size=(320, 240))
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        print(f"[config4 {card}] {res['zarr_shape']} zlib Zarr, time lag 2, "
              f"orbit_path(4) at 320x240: warm pass "
              f"{res['compile_pass_ms']:.1f} ms, timed pass "
              f"{res['total_ms']:.1f} ms ({res['ms_per_frame']:.1f} ms a "
              f"frame, PNGs included; host clock); a frame's launches "
              f"{launches}; card vs CPU (1 thread) over the "
              f"{len(res['cameras'])} frames: max-abs {worst:.3e} (bar "
              f"{MAX_ABS_FRAME}), min SSIM {least:.6f} (bar "
              f"{MIN_SSIM_FRAME})")
        assert all(launches.get(k, 0) >= 1 for k in FAST_PATH), launches
        assert worst <= MAX_ABS_FRAME and least >= MIN_SSIM_FRAME
        del res, res_cpu, scene

        # The time-lag store: 250^3 x 40 steps, one member, float32.
        side, steps, lag = HEADLINE_SIDE, TIMELAG_STEPS, TIMELAG_LAG
        gen = torch.Generator(device=dev).manual_seed(11)
        t0 = time.perf_counter()
        series = synth_box_stack(side, side, side, steps, gen, dev)
        host = series.permute(3, 0, 1, 2).contiguous().cpu().numpy()
        del series
        store = root / "timelag.zarr"
        write_zarr_array(str(store / "q"), host, (1, side, side, side),
                         compressor=None)
        gbytes = host.nbytes / 1e9
        del host
        write_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        vd = load_volume(str(store), device=dev)
        open_ms = (time.perf_counter() - t0) * 1e3
        assert (vd.grid.ts, vd.grid.es) == (steps, 1), vd.grid
        t0 = time.perf_counter()
        for t in range(steps):
            vd.get_field("q", t, 0)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tstack = vd.get_time_stack("q", 0)
        torch.cuda.synchronize()
        tstack_ms = (time.perf_counter() - t0) * 1e3
        p = (side // 4, side // 4, side // 2)
        cam = config1_camera()
        scene = Scene(vd, [cam])
        calc = CorrelationCalculator(field_name="q", ensemble_mode=False,
                                     time_lag=lag, reference_point=p)
        name = scene.add_calculator(calc)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        field = vd.get_field(name, 0, 0)
        end.record()
        torch.cuda.synchronize()
        first_ms = start.elapsed_time(end)
        field_ms = median_ms(lambda: calc.compute(0, 0))
        n = steps - lag
        idx = torch.arange(0, side**3, GRID_CHECK_STEP, device=dev)
        flat = tstack.reshape(-1, steps)
        want = pearson(tstack[p[2], p[1], p[0], lag:].double(),
                       flat[idx, :n].double(), dtype=torch.float64)
        err = max_abs(field.reshape(-1)[idx], want)
        print(f"[timelag {card}] store {side}^3 x {steps} steps f32, "
              f"uncompressed chunks of one step ({gbytes:.2f} GB; drawn and "
              f"written in {write_s:.1f} s): load_volume {open_ms:.3f} ms "
              f"(metadata), {steps} slabs read and uploaded {load_ms:.1f} ms, "
              f"time stack {tstack_ms:.3f} ms; field (time lag {lag}, n = "
              f"{n}) first {first_ms:.3f} ms, then {field_ms:.3f} ms (median "
              f"of 5); max|field - f64| {err:.3e} over every "
              f"{GRID_CHECK_STEP}th voxel (bar {ATOL_PEARSON})")
        assert err <= ATOL_PEARSON
        errs["pearson"] = max(errs["pearson"], err)
        # K1 keeps its tiled regime for the lag windows: correlate_field
        # copies the flattened window into a fresh buffer, whose base is
        # 16-byte aligned (csrc/pearson.cu:356-358 picks the regime from
        # that and n <= 2048). The inputs each lag hands K1 are recorded,
        # and one profiler window over both lags must name only the
        # tiled kernel.
        from torch.profiler import ProfilerActivity, profile

        from correrender_tpu_torch.calculators import correlation

        handed = []
        pearson_cuda = correlation.pearson_cuda

        def recording(series, ref_):
            handed.append((series.is_contiguous(),
                           series.data_ptr() % 16 == 0, series.shape[-1]))
            return pearson_cuda(series, ref_)

        calcs = [CorrelationCalculator(field_name="q", ensemble_mode=False,
                                       time_lag=lag_, reference_point=p)
                 for lag_ in (lag, -lag)]
        for c in calcs:
            c.bind(vd)
            c.compute(0, 0)
        torch.cuda.synchronize()
        correlation.pearson_cuda = recording
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for c in calcs:
                    for _ in range(10):
                        c.compute(0, 0)
                torch.cuda.synchronize()
        finally:
            correlation.pearson_cuda = pearson_cuda
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "pearson" in e.key}
        print(f"[timelag {card}] time lags +{lag} and -{lag}: K1 handed "
              f"(contiguous, 16-byte aligned, n) {sorted(set(handed))} in "
              f"{len(handed)} calls; the profiler names {kernels}")
        assert handed and all(c and al and n <= 2048 for c, al, n in handed)
        assert any("pearson_tiled_kernel" in k for k in kernels), kernels
        assert not any("pearson_direct_kernel" in k for k in kernels), (
            kernels)
        # The flythrough, stepping the time.
        scene.transfer_functions[name] = config1_transfer_function(dev)
        scene.add_renderer("dvr", field=name)
        state = {"in_flight": 0, "most": 0, "computes": 0, "write_s": 0.0}
        render_view, compute = scene.render_view, calc.compute

        def counted_render(view, image_size):
            state["in_flight"] += 1
            state["most"] = max(state["most"], state["in_flight"])
            return render_view(view, image_size=image_size)

        def counted_write(path, img):
            state["in_flight"] -= 1
            t_write = time.perf_counter()
            write_png(path, img)  # fetches the frame, then encodes it
            state["write_s"] += time.perf_counter() - t_write

        def counted_compute(t, e):
            state["computes"] += 1
            return compute(t, e)

        scene.render_view = counted_render
        camera_path.write_png = counted_write
        calc.compute = counted_compute
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        # From time step 1: step 0's field was computed above.
        files = render_flythrough(scene, orbit_path(FLY_FRAMES),
                                  str(root / "fly"), image_size=HEADLINE_IMAGE,
                                  time_indices=list(range(1, n)))
        torch.cuda.synchronize()
        fly_ms = (time.perf_counter() - t0) * 1e3
        camera_path.write_png = write_png
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated(dev)
        frame_ms = fly_ms / FLY_FRAMES
        write_ms = 1e3 * state["write_s"] / FLY_FRAMES
        print(f"[timelag {card}] render_flythrough of orbit_path"
              f"({FLY_FRAMES}) at {HEADLINE_IMAGE[0]}x{HEADLINE_IMAGE[1]}, "
              f"a time step a frame: {fly_ms:.1f} ms ({frame_ms:.1f} ms a "
              f"frame, PNG encoding included; host clock; waiting for, "
              f"fetching and encoding {write_ms:.1f} ms a frame of it); "
              f"launches {launches}; the field computed {state['computes']} "
              f"times "
              f"(cached per time step, as in JAX); most frames in flight "
              f"{state['most']}; peak max_memory_allocated "
              f"{peak / 2**30:.2f} GiB")
        assert len(files) == FLY_FRAMES and state["in_flight"] == 0
        assert state["most"] <= camera_path.MAX_IN_FLIGHT
        assert state["computes"] == FLY_FRAMES
        assert all(launches.get(k, 0) == FLY_FRAMES for k in FAST_PATH), (
            launches)
        del scene, vd, tstack, field, flat
    finally:
        camera_path.write_png = write_png
        shutil.rmtree(root, ignore_errors=True)


def premultiplied(img: torch.Tensor) -> torch.Tensor:
    return torch.cat([img[..., :3] * img[..., 3:4], img[..., 3:4]], -1)


def frames_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` (no warm-up:
    the caller has run it)."""
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


def phase_iso_sharded(dev, card: str) -> None:
    """22. The sharded isosurface (see the module docstring)."""
    import gc

    import torch.distributed as dist

    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.parallel import iso_shearwarp_sharded, make_mesh
    from correrender_tpu_torch.render.camera import Camera
    from correrender_tpu_torch.render.iso_fast import iso_shearwarp
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated(dev)
    gc.collect()  # reference cycles of the earlier phases' objects
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(dev)
    print(f"[iso sharded {card}] allocated when the phase starts: "
          f"{held / 2**30:.2f} GiB, {after / 2**30:.2f} GiB after a garbage "
          f"collection")
    xs, ys, zs = ISO_SHARDED_GRID
    gen = torch.Generator(device=dev).manual_seed(22)
    stack = synth_box_stack(xs, ys, zs, ISO_SHARDED_MEMBERS, gen, dev)
    field = correlate_field(stack, stack[zs // 2, ys // 4, xs // 4])
    del stack
    mesh = make_mesh(members=1, device_type="cuda")
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for cam_name, pos in ISO_SHARDED_CAMERAS.items():
        cam = Camera(position=pos)
        for ss in (1, 2):
            kw = dict(image_size=HEADLINE_IMAGE, intermediate_scale=1.0,
                      background=(0, 0, 0, 0), axial_supersample=ss)

            def sharded():
                return iso_shearwarp_sharded(field, cam, ISO_SHARDED_VALUE,
                                             mesh, **kw)

            def dense():
                return iso_shearwarp(field, cam, ISO_SHARDED_VALUE, **kw)

            got, want = sharded(), dense()
            err = float((premultiplied(got) - premultiplied(want)).abs().max())
            hits = float((got[..., 3] > 0.5).float().mean())
            ms = frames_ms(sharded)
            dense_ms = frames_ms(dense)
            print(f"[iso sharded {card}] camera {cam_name}, axial supersample"
                  f" {ss}, {HEADLINE_IMAGE[0]}x{HEADLINE_IMAGE[1]} at "
                  f"{xs}x{ys}x{zs}: {ms:.3f} ms (median of 5; the dense "
                  f"iso_shearwarp {dense_ms:.3f} ms, median of 5); vs the "
                  f"dense frame premultiplied max-abs {err:.3e} (bar "
                  f"{ATOL_ISO_SHARDED_PORT}, the CPU tests' between the two "
                  f"port paths; JAX's cross-package bar {ATOL_ISO_SHARDED});"
                  f" {hits:.4f} of the pixels hit")
            assert err <= ATOL_ISO_SHARDED_PORT <= ATOL_ISO_SHARDED
            assert hits > 0.0 and bool(torch.isfinite(got).all())
    print(f"[iso sharded {card}] peak max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; the "
          f"phase {time.perf_counter() - t_phase:.1f} s")


def phase_stress(dev, card: str) -> None:
    """23. The stress runs (see the module docstring)."""
    import torch.distributed as dist

    from correrender_tpu_torch.parallel import (
        stress_pearson, stress_rank_ksg, stress_reshard)

    t_phase = time.perf_counter()
    try:
        torch.cuda.synchronize()
        row = stress_pearson(grid=STRESS_PEARSON_GRID,
                             members=STRESS_MEMBERS, mesh_shape=(1, 1),
                             dtype="bfloat16", device="cuda")
        print(f"[stress {card}] {json.dumps(row)}")
        delta = row["max_abs_delta_vs_streamed_f64"]
        peak = row["compiled_temp_output_bytes_per_device"] or 0
        print(f"[stress {card}] stress_pearson: {row['stack_gb']:.3f} GiB "
              f"bfloat16, {row['compute_s'] * 1e3:.3f} ms, "
              f"{row['gvox_per_s']:.4f} Gvox/s, peak {peak / 2**30:.2f} "
              f"GiB; max |r - float64| {delta:.3e} over "
              f"{row['z_slabs_checked']} planes (bar {ATOL_STRESS_PEARSON};"
              f" the JAX package recorded {JAX_STRESS_PEARSON:.3e})")
        assert row["max_abs_delta_vs_streamed_f64"] <= ATOL_STRESS_PEARSON
        assert row["z_slabs_checked"] == STRESS_PEARSON_GRID[0] // 4
        row = stress_reshard(grid=STRESS_PEARSON_GRID,
                             members=STRESS_MEMBERS, mesh_shape=(1, 1),
                             dtype="bfloat16", device="cuda")
        print(f"[stress {card}] {json.dumps(row)}")
        assert row["content_max_delta"] == 0.0
        for measure, grid, kernel in (
                ("spearman", STRESS_RANK_GRID, "spearman"),
                ("kendall", STRESS_RANK_GRID, "kendall"),
                ("mi_kraskov", STRESS_KSG_GRID, "mi_ksg_banded")):
            row = stress_rank_ksg(measure, grid=grid,
                                  members=STRESS_MEMBERS, device="cuda")
            print(f"[stress {card}] {json.dumps(row)}")
            print(f"[stress {card}] stress_rank_ksg {measure}: "
                  f"{row['compute_s'] * 1e3:.3f} ms, "
                  f"{row['voxels_per_s']:.0f} voxels/s, launches of the "
                  f"timed call {row['timed_launches']}, vs the dense "
                  f"correlate_field {row['max_abs_delta_vs_dense']:.3e}")
            assert row["timed_launches"] == {kernel: 1}, row
            assert row["max_abs_delta_vs_dense"] == 0.0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[stress {card}] the phase {time.perf_counter() - t_phase:.1f} s")


def phase_multihost(dev, card: str) -> None:
    """24. The multi-host worker (see the module docstring)."""
    import os
    import shutil

    from correrender_tpu_torch.app.baseline_configs import config5_stack
    from correrender_tpu_torch.io.writers import write_zarr
    from correrender_tpu_torch.parallel.multihost_worker import launch

    t_phase = time.perf_counter()
    xs, ys, zs = MULTIHOST_GRID
    os.makedirs(MULTIHOST_DIR, exist_ok=True)
    try:
        t0 = time.perf_counter()
        stack = config5_stack(MULTIHOST_GRID, MULTIHOST_MEMBERS, (0, zs), dev)
        data = stack.permute(3, 0, 1, 2).contiguous().cpu().numpy()
        del stack
        path = os.path.join(MULTIHOST_DIR, "ensemble.zarr")
        write_zarr(path, data[:, None], compressor=None)  # (E, T, Z, Y, X)
        del data
        write_s = time.perf_counter() - t0
        # The child shares the card: hand it the blocks this process's
        # allocator keeps cached from the earlier phases.
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = launch(processes=1, dataset=path,
                     out=os.path.join(MULTIHOST_DIR, "multihost.json"),
                     device="cuda", timeout=600)
        run_s = time.perf_counter() - t0
        print(f"[multihost {card}] {json.dumps(res)}")
        print(f"[multihost {card}] one NCCL worker process over tcp://"
              f"127.0.0.1 on a {res['grid']} x {res['members']} Zarr store "
              f"(written in {write_s:.1f} s): load "
              f"{res['load_s_per_process']:.3f} s, Pearson "
              f"{res['pearson_warm_ms']:.3f} ms, reshard "
              f"{res['reshard_warm_ms']:.3f} ms (host clock, synchronized);"
              f" the child {run_s:.1f} s; Pearson vs float64 "
              f"{res['pearson_max_delta_vs_f64']:.3e} (bar 1e-5), vs the "
              f"one-process K1 field "
              f"{res['pearson_max_delta_vs_singleproc']:.3e} (bar 1e-5), "
              f"Spearman vs float64 {res['spearman_max_delta_vs_f64']:.3e} "
              f"(bar 1e-4), reshard {res['reshard_max_delta']}; the "
              f"child's launches: Spearman {res['spearman_launches']}, "
              f"one-process Pearson {res['singleproc_launches']}")
        assert res["ok"] and res["num_processes"] == 1
        assert res["spearman_launches"] == {"spearman": 1}, res
        assert res["singleproc_launches"] == {"pearson": 1}, res
        assert res["device"].startswith("cuda")
        assert res["grid"] == [zs, ys, xs]
        assert res["pearson_max_delta_vs_f64"] < 1e-5
        assert res["pearson_max_delta_vs_singleproc"] < 1e-5
        assert res["spearman_max_delta_vs_f64"] < 1e-4
        assert res["reshard_max_delta"] == 0.0
    finally:
        shutil.rmtree(MULTIHOST_DIR, ignore_errors=True)
    print(f"[multihost {card}] the phase {time.perf_counter() - t_phase:.1f}"
          " s")


def write_vti_zlib_appended(path: str, field: np.ndarray, name: str,
                            block: int = 32768) -> None:
    """A VTK XML ImageData file with one zlib-compressed appended array,
    as VTK's writer lays it out (32 KiB blocks, UInt32 header)."""
    import zlib

    raw = np.ascontiguousarray(field, "<f4").tobytes()
    blocks = [zlib.compress(raw[i:i + block], 1)
              for i in range(0, len(raw), block)]
    last = len(raw) - (len(blocks) - 1) * block
    header = np.array([len(blocks), block, last] + [len(b) for b in blocks],
                      np.uint32).tobytes()
    zs, ys, xs = field.shape
    head = (
        '<?xml version="1.0"?>\n<VTKFile type="ImageData" version="0.1" '
        'byte_order="LittleEndian" compressor="vtkZLibDataCompressor">\n'
        f'<ImageData WholeExtent="0 {xs - 1} 0 {ys - 1} 0 {zs - 1}" '
        'Origin="0 0 0" Spacing="1 1 1">\n'
        f'<Piece Extent="0 {xs - 1} 0 {ys - 1} 0 {zs - 1}"><PointData>'
        f'<DataArray type="Float32" Name="{name}" format="appended" '
        'offset="0"/></PointData></Piece>\n</ImageData>\n'
        '<AppendedData encoding="raw">\n_').encode()
    with open(path, "wb") as f:
        f.write(head + header + b"".join(blocks)
                + b"\n</AppendedData>\n</VTKFile>\n")


def write_nii_gz(path: str, field: np.ndarray) -> None:
    """A gzipped NIfTI-1 float32 volume (348-byte header, data at 352)."""
    import gzip
    import struct

    zs, ys, xs = field.shape
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, 3, xs, ys, zs, 1, 1, 1, 1)
    struct.pack_into("<h", header, 70, 16)  # float32
    struct.pack_into("<8f", header, 76, 1, 1, 1, 1, 1, 1, 1, 1)
    struct.pack_into("<f", header, 108, 352.0)
    struct.pack_into("<f", header, 112, 1.0)
    with open(path, "wb") as f:
        f.write(gzip.compress(bytes(header) + np.ascontiguousarray(
            field, "<f4").tobytes(), compresslevel=1))


def write_mhd(path: str, field: np.ndarray) -> None:
    import os

    zs, ys, xs = field.shape
    raw = os.path.splitext(path)[0] + ".raw"
    np.ascontiguousarray(field, "<f4").tofile(raw)
    with open(path, "w") as f:
        f.write(f"ObjectType = Image\nNDims = 3\nDimSize = {xs} {ys} {zs}\n"
                "ElementType = MET_FLOAT\nElementSpacing = 1 1 1\n"
                f"ElementDataFile = {os.path.basename(raw)}\n")


def era5_member(member: int, dev) -> np.ndarray:
    """Member ``member`` of a synthetic ERA5-like temperature field
    (K) on the 37 pressure levels, ``(levels, lat, lon)``: a lapse-rate
    profile, a meridional gradient, waves and member noise, drawn on the
    card."""
    ni, nj = ERA5_GRID
    p = torch.tensor(ERA5_LEVELS, dtype=torch.float32, device=dev)
    lat = torch.linspace(-90.0, 90.0, nj, device=dev)
    lon = torch.linspace(0.0, 359.5, ni, device=dev)
    height = 7.0 * torch.log(1000.0 / p)  # km
    t = (288.0 - 6.5 * torch.clamp(height, max=11.0))[:, None, None]
    t = t - 30.0 * torch.sin(torch.deg2rad(lat))[None, :, None] ** 2
    t = t + 3.0 * torch.sin(torch.deg2rad(3.0 * lon))[None, None, :] * \
        torch.cos(torch.deg2rad(lat))[None, :, None]
    gen = torch.Generator(device=dev).manual_seed(2500 + member)
    t = t + 0.5 * torch.randn(t.shape, generator=gen, device=dev)
    return t.cpu().numpy()


def decoder_frame(card: str, vd, name: str, tf, label: str, expect: dict):
    """One 1920x1080 DVR Scene frame of ``name``, its launches counted."""
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.render.camera import Camera

    scene = Scene(vd, [Camera(position=(0.05, 0.2, 0.9))])
    scene.transfer_functions[name] = tf
    scene.renderers = [{"type": "dvr", "view": 0, "field": name}]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    img = scene.render_view(0, image_size=HEADLINE_IMAGE)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    print(f"[decoders {card}] {label}: one {HEADLINE_IMAGE[0]}x"
          f"{HEADLINE_IMAGE[1]} Scene frame {ms:.3f} ms (host clock, the "
          f"first, field computed and cached), launches {launches}")
    assert launches == expect, launches
    assert img.shape == HEADLINE_IMAGE[::-1] + (4,)
    assert bool(torch.isfinite(img).all()) and float(img[..., 3].max()) > 0


def phase_decoders(dev, card: str) -> None:
    """25. The decoders (see the module docstring)."""
    import os
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from correrender_tpu_torch.calculators.correlation import (
        CorrelationCalculator)
    from correrender_tpu_torch.io import codec, grib, load_volume
    from correrender_tpu_torch.io.base import loader_for_path
    from correrender_tpu_torch.io.writers import write_cvol
    from correrender_tpu_torch.render.tf import TransferFunction
    from correrender_tpu_torch.utils.fixtures import (
        synth_box_lambda_field_torch)

    t_phase = time.perf_counter()
    os.makedirs(DECODERS_DIR, exist_ok=True)
    try:
        # (a) The ERA5 ensemble in GRIB2, one file a member, written on
        # every host core (the writer's bit packing is numpy).
        ni, nj = ERA5_GRID
        members = [era5_member(m, dev) for m in range(ERA5_MEMBERS)]
        paths = [os.path.join(DECODERS_DIR, f"era5_pl_member{m}.grib2")
                 for m in range(ERA5_MEMBERS)]

        def write_member(m):
            grib.write_grib2(paths[m], {"t": members[m]},
                             levels=list(ERA5_LEVELS), lat=(-90.0, 90.0),
                             lon=(0.0, 359.5), nbits=16, date=20200101,
                             time=1200)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            list(pool.map(write_member, range(ERA5_MEMBERS)))
        write_s = time.perf_counter() - t0
        del members
        mb = ERA5_MEMBERS * len(ERA5_LEVELS) * ni * nj * 4 / 1e6
        file_mb = sum(os.path.getsize(p) for p in paths) / 1e6
        codec.library()  # the build, outside the decode's time
        calls = dict(codec.CALLS)
        vd = load_volume(paths, device=dev)
        t0 = time.perf_counter()
        for m in range(ERA5_MEMBERS):
            vd.get_field("t", 0, m)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        native = {k: codec.CALLS[k] - calls[k] for k in calls}
        print(f"[decoders {card}] GRIB2 ERA5 ensemble on pressure levels "
              f"({ERA5_MEMBERS} members x {len(ERA5_LEVELS)} levels x "
              f"{ni}x{nj}, {mb:.1f} MB float32 in {file_mb:.1f} MB of GRIB2"
              f"): written in {write_s:.3f} s; load_volume on the card "
              f"(decode and upload) {load_s:.3f} s, {mb / load_s:.1f} MB/s; "
              f"native codec calls {native}")
        assert native["unpack_bits"] == ERA5_MEMBERS * len(ERA5_LEVELS)
        # Each member against the numpy decode of its file (every host
        # core, a member a task).
        def plain_member(path):
            loader = grib.GribLoader().open(path)
            out = np.stack([grib._decode_values(
                loader._buf, loader._index[("t", 0, z)], None)
                for z in range(loader.zs)])
            loader.close()
            return out

        t0 = time.perf_counter()
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            for m, want in enumerate(pool.map(plain_member, paths)):
                got = vd.get_field("t", 0, m).cpu().numpy()
                assert np.array_equal(got, want), f"member {m} differs"
        print(f"[decoders {card}] every member on the card equal to the "
              f"bit to the numpy decode ({time.perf_counter() - t0:.1f} s)")
        calc = CorrelationCalculator(field_name="t", reference_point=(
            ni // 2, nj // 2, len(ERA5_LEVELS) // 2))
        vd.add_calculator(calc)
        decoder_frame(card, vd, calc.output_name,
                      TransferFunction.from_colormap("coolwarm",
                                                     domain=(-1, 1),
                                                     device=dev),
                      "GRIB2 Pearson field",
                      {"pearson": 1, "classify_to_cf": 1,
                       "shearwarp_composite": 1})
        del vd, calc

        # (b) A 250^3 field in four formats.
        # The planted-box field with 1% noise: float data that compresses
        # as a simulation's output does, not as runs of zeros.
        side = DECODER_SIDE
        gen = torch.Generator(device=dev).manual_seed(25)
        lam = synth_box_lambda_field_torch(side, side, side, device=dev)
        field = (lam + 0.01 * torch.randn(lam.shape, generator=gen,
                                          device=dev)).cpu().numpy()
        del lam
        mb = field.nbytes / 1e6
        writers = {
            "vti": lambda p: write_vti_zlib_appended(p, field, "lambda"),
            "nii.gz": lambda p: write_nii_gz(p, field),
            "cvol": lambda p: write_cvol(p, field),
            "mhd": lambda p: write_mhd(p, field),
        }
        for ext, write in writers.items():
            path = os.path.join(DECODERS_DIR, f"field.{ext}")
            t0 = time.perf_counter()
            write(path)
            write_s = time.perf_counter() - t0
            loader = loader_for_path(path).open(path)
            name = loader.field_names[0]
            t0 = time.perf_counter()
            arr = loader.load_field(name)
            decode_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            on_card = torch.from_numpy(np.array(arr, np.float32)).to(dev)
            torch.cuda.synchronize()
            upload_s = time.perf_counter() - t0
            vd = load_volume(path, device=dev)
            got = vd.get_field(name)
            assert torch.equal(got, on_card)
            assert np.array_equal(got.cpu().numpy(), field), ext
            disk = sum(os.path.getsize(f) for f in (
                path, os.path.splitext(path)[0] + ".raw") if os.path.exists(f)
                ) if ext == "mhd" else os.path.getsize(path)
            print(f"[decoders {card}] {ext} {side}^3 float32 ("
                  f"{disk / 1e6:.1f} MB on disk): write "
                  f"{write_s:.3f} s, decode {decode_s:.3f} s "
                  f"({mb / decode_s:.1f} MB/s), upload {upload_s:.3f} s; on"
                  f" the card equal to the bit to what was written")
            decoder_frame(card, vd, name, TransferFunction.from_colormap(
                "coolwarm", domain=(-1, 1), device=dev), f"{ext} DVR",
                {"classify_to_cf": 1, "shearwarp_composite": 1})
            del vd, got, on_card, arr
    finally:
        shutil.rmtree(DECODERS_DIR, ignore_errors=True)
    print(f"[decoders {card}] the phase {time.perf_counter() - t_phase:.1f}"
          " s")


def tree_max_abs(a, b) -> float:
    """Max |a − b| over the leaves of two parameter trees (b on the CPU)."""
    from correrender_tpu_torch.models.tree import tree_leaves

    return max(float((x.cpu() - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def paired_adam(params, loss_fn, steps: int, lr: float, check, dev):
    """``steps`` Adam steps from the card's parameters and Adam state, the
    same step taken on the card and on the CPU: ``loss_fn(p, i, device)``
    is step i's loss on that device's copy of the same inputs, and
    ``check(i, card_next, cpu_next, card_loss, cpu_loss)`` returns the
    step's error. Returns the largest error."""
    from correrender_tpu_torch.models.mine import adam_step
    from correrender_tpu_torch.models.tree import tree_map

    def cpu(tree):
        return tree_map(lambda t: t.cpu(), tree)

    state = (tree_map(torch.zeros_like, params),
             tree_map(torch.zeros_like, params))
    worst = 0.0
    for i in range(steps):
        t = torch.tensor(float(i + 1))
        nxt, nstate, loss = adam_step(params, state,
                                      lambda p: loss_fn(p, i, dev), lr,
                                      t.to(dev))
        cnxt, _, closs = adam_step(cpu(params), cpu(state),
                                   lambda p: loss_fn(p, i, "cpu"), lr, t)
        worst = max(worst, check(i, nxt, cnxt, float(loss), float(closs)))
        params, state = nxt, nstate
    return worst


def neural_config1(dev, card: str) -> None:
    """26 (a): the neural models and calculator at config 1's grid, card
    against the CPU (one thread) on the same inputs."""
    from correrender_tpu_torch.calculators.neural import (
        NeuralCorrelationCalculator)
    from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
    from correrender_tpu_torch.models.mine import (
        CorrelationSRN, MineEstimator, train_mine_batched)
    from correrender_tpu_torch.models.tree import tree_map
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    (xs, ys, zs), members = CONFIG1_GRID, 100
    stack = synth_box_stack(xs, ys, zs, members,
                            torch.Generator(device=dev).manual_seed(11), dev)
    host = stack.cpu()
    grid = GridMetadata(xs=xs, ys=ys, zs=zs, es=members)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see ROADMAP C
    t0 = time.perf_counter()
    try:
        vds = {}
        for device, data in ((dev, stack), ("cpu", host)):
            vds[device] = VolumeData(grid, device=device)
            vds[device].add_field("q", lambda t, e, d=data: d[..., e])
        calcs = {d: NeuralCorrelationCalculator(field_name="q",
                                                reference_point=(40, 70, 12))
                 for d in vds}
        for d, calc in calcs.items():
            vds[d].add_calculator(calc)
        sets = {d: c.training_set(0, NEURAL_CHECK_REFS)
                for d, c in calcs.items()}
        assert torch.equal(sets[dev].voxels.cpu(), sets["cpu"].voxels)
        target_err = max_abs(sets[dev].targets, sets["cpu"].targets.to(dev))
        print(f"[neural {card}] (a) training set of {NEURAL_CHECK_REFS} "
              f"reference points at {xs}x{ys}x{zs} x {members}: "
              f"{len(sets[dev])} samples, voxels equal, targets card vs "
              f"CPU {target_err:.3e} (bar {ATOL_PEARSON})")
        assert target_err <= ATOL_PEARSON
        gen = torch.Generator().manual_seed(12)
        sample = torch.randint(0, len(sets[dev]), (NEURAL_CHECK_SAMPLES,),
                               generator=gen)
        inputs = {dev: sets[dev].take(sample.to(dev))}
        inputs["cpu"] = tuple(t.cpu() for t in inputs[dev])
        batches = torch.randint(0, len(sets[dev]), (
            NEURAL_CHECK_STEPS, NEURAL_CHECK_BATCH), generator=gen)
        for kind, kw in NEURAL_MODELS.items():
            model = CorrelationSRN.create(**kw)
            params = model.init(torch.Generator().manual_seed(13))
            on = {dev: tree_map(lambda t: t.to(dev), params), "cpu": params}
            with torch.no_grad():
                out = {d: model(on[d], *inputs[d][:2]) for d in on}
            fwd = max_abs(out[dev].cpu(), out["cpu"])
            fields = {}
            for d, calc in calcs.items():
                calc.model, calc.params = model, on[d]
                fields[d] = calc.compute(0, 0)
            field = max_abs(fields[dev].cpu(), fields["cpu"])
            assert fwd <= ATOL_NEURAL_FORWARD and field <= ATOL_NEURAL_FORWARD

            def loss_fn(p, i, device, model=model):
                pr, pq, tg = (t.to(device) for t in sets[dev].take(
                    batches[i].to(dev)))
                return torch.mean((model(p, pr, pq) - tg) ** 2)

            def check(i, nxt, cnxt, loss, closs):
                return max(tree_max_abs(nxt, cnxt), abs(loss - closs))

            step = paired_adam(on[dev], loss_fn, NEURAL_CHECK_STEPS, 3e-3,
                               check, dev)
            print(f"[neural {card}] (a) {kind} SRN: forward on "
                  f"{NEURAL_CHECK_SAMPLES} samples card vs CPU {fwd:.3e}, "
                  f"compute over the grid {field:.3e} (bar "
                  f"{ATOL_NEURAL_FORWARD}); {NEURAL_CHECK_STEPS} paired Adam "
                  f"steps (batch {NEURAL_CHECK_BATCH}): parameters and loss "
                  f"{step:.3e} (bar {ATOL_NEURAL_STEP})")
            assert step <= ATOL_NEURAL_STEP

        # MINE: P independent statistic networks, stacked.
        est = MineEstimator.create()
        x = torch.randn(MINE_PAIRS, MINE_SAMPLES, generator=gen)
        w = torch.linspace(0.95, 0.0, MINE_PAIRS)[:, None]
        y = w * x + (1 - w) * torch.randn(x.shape, generator=gen)
        series = {dev: (x.to(dev), y.to(dev)), "cpu": (x, y)}
        perms = torch.rand(MINE_STEPS + 1, MINE_PAIRS, MINE_SAMPLES,
                           generator=gen).argsort(-1)
        inits = [est.init(gen) for _ in range(MINE_PAIRS)]
        stacked = tree_map(lambda *ls: torch.stack(ls).to(dev), *inits)

        def bound(p, i, device):
            return est.mi_lower_bound(p, *series[device],
                                      perms[i].to(device))

        def mine_check(i, nxt, cnxt, loss, closs):
            with torch.no_grad():
                after = max_abs(bound(nxt, i + 1, dev).cpu(),
                                bound(cnxt, i + 1, "cpu"))
            return max(after, abs(loss - closs) / MINE_PAIRS)

        step = paired_adam(stacked, lambda p, i, d: -bound(p, i, d).sum(),
                           MINE_STEPS, 1e-3, mine_check, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mi = train_mine_batched(est, *series[dev], steps=MINE_STEPS)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        mi_cpu = train_mine_batched(est, x, y, steps=MINE_STEPS)
        free = max_abs(mi.cpu(), mi_cpu)
        print(f"[neural {card}] (a) MINE, {MINE_PAIRS} pairs of "
              f"{MINE_SAMPLES} samples, {MINE_STEPS} paired Adam steps: "
              f"each pair's bound card vs CPU {step:.3e} (bar "
              f"{ATOL_NEURAL_STEP}); train_mine_batched free-running on the "
              f"card {card_s * 1e3:.1f} ms, MI "
              f"{[round(v, 4) for v in mi.tolist()]}, card vs CPU "
              f"{free:.3e} (not held: a ReLU input within a "
              f"rounding of zero switches sides in one run only)")
        assert step <= ATOL_NEURAL_STEP
        assert bool(torch.isfinite(mi).all()) and float(mi[0]) > float(mi[-1])
    finally:
        torch.set_num_threads(threads)
    print(f"[neural {card}] (a) held, {time.perf_counter() - t0:.1f} s with "
          f"the CPU on one thread")


def neural_fit(card: str, calc, label: str) -> None:
    """26 (b): the headline fit, timed with its K1 launches (CUDA events
    around each ``correlate_field``) and its step loop."""
    from correrender_tpu_torch.calculators import neural
    from correrender_tpu_torch.ops.cuda import _build

    field_events, loop = [], {}
    correlate, fit_srn = neural.correlate_field, neural.fit_srn

    def timed_field(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = correlate(*args, **kw)
        end.record()
        field_events.append((start, end))
        return out

    def timed_loop(*args, **kw):
        torch.cuda.synchronize()
        loop["start"] = time.perf_counter()
        out = fit_srn(*args, **kw)
        torch.cuda.synchronize()
        loop["s"] = time.perf_counter() - loop["start"]
        return out

    neural.correlate_field, neural.fit_srn = timed_field, timed_loop
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        loss = calc.fit(0, num_reference_points=NEURAL_REFS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        neural.correlate_field, neural.fit_srn = correlate, fit_srn
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    k1_ms = sum(s.elapsed_time(e) for s, e in field_events)
    print(f"[neural {card}] (b) {label} fit: {fit_s:.3f} s "
          f"({calc.train_steps} steps, batch 4096, {NEURAL_REFS} reference "
          f"points): launches {launches}, the {len(field_events)} fields "
          f"{k1_ms:.3f} ms of CUDA-event time, the training set "
          f"{loop['start'] - t0:.3f} s, the step loop {loop['s']:.3f} s "
          f"({calc.train_steps / loop['s']:.1f} steps/s); final loss "
          f"{loss:.6f}")
    assert launches == {"pearson": NEURAL_REFS}, launches
    assert math.isfinite(loss)


def phase_neural(dev, card: str, vd) -> None:
    """26. The neural correlation calculator (see the module docstring)."""
    import os
    import shutil

    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.calculators.correlation import (
        CorrelationCalculator)
    from correrender_tpu_torch.calculators.neural import (
        NeuralCorrelationCalculator)
    from correrender_tpu_torch.models.mine import CorrelationSRN
    from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp

    t_phase = time.perf_counter()
    neural_config1(dev, card)
    side = vd.grid.xs
    p1 = (side // 4, side // 4, side // 2)
    p2 = (side // 4 + 3, side // 4, side // 2)
    cam = config1_camera()
    image_size = HEADLINE_IMAGE
    base = dict(image_size=image_size, box=vd.grid.render_box(),
                background=(0, 0, 0, 0))

    def frame_of(calc, label, expect, forbid=()):
        scene = Scene(vd, [cam])
        name = scene.add_calculator(calc)
        scene.transfer_functions[name] = config1_transfer_function(dev)
        scene.renderers = [{"type": "dvr", "view": 0, "field": name}]
        ms, _ = scene_frame_check(
            card, f"(b) {label}: point moved", lambda: scene.render_view(
                0, image_size=image_size),
            lambda i: calc.set_reference_point(*(p2 if i % 2 else p1)),
            lambda: dvr_shearwarp(calc.compute(0, 0), cam,
                                  scene.tf_for(name), **base),
            expect=expect, forbid=forbid)
        vd.remove_calculator(name)
        return ms

    pearson = frame_of(CorrelationCalculator(field_name="q",
                                             reference_point=p1,
                                             output_name="pearson 26"),
                       "Pearson calculator", FAST_PATH)
    os.makedirs(NEURAL_DIR, exist_ok=True)
    try:
        preset = os.path.join(NEURAL_DIR, "frequency.npz")
        for kind, kw in NEURAL_MODELS.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            calc = NeuralCorrelationCalculator(
                field_name="q", reference_point=p1,
                model=CorrelationSRN.create(**kw),
                train_steps=NEURAL_TRAIN_STEPS, output_name=f"neural {kind}")
            calc.bind(vd)
            neural_fit(card, calc, kind)
            field = calc.compute(0, 0)
            assert field.shape == vd.grid.shape_zyx
            assert bool(torch.isfinite(field).all())
            compute_ms = median_ms(lambda: calc.compute(0, 0))
            ms = frame_of(calc, f"{kind} SRN", FAST_PATH[1:],
                          forbid=("pearson",))
            peak = torch.cuda.max_memory_allocated(dev)
            print(f"[neural {card}] (b) {kind} SRN at {side}^3: compute over "
                  f"the grid {compute_ms:.3f} ms (median of 5); the point-move"
                  f" frame {ms:.3f} ms against the Pearson calculator's "
                  f"{pearson:.3f} ms; peak max_memory_allocated "
                  f"{peak / 2**30:.2f} GiB (the headline stack and the "
                  f"earlier phases' cache included)")
            if kind == "frequency":
                calc.save_weights(preset)
            del calc, field

        # (c) A reference state file naming the calculator and its preset.
        direct = NeuralCorrelationCalculator(field_name="q",
                                             reference_point=p2,
                                             weights_path=preset)
        direct.bind(vd)
        want = direct.compute(0, 0)
        scene = Scene(vd, [cam])
        name = scene.add_calculator(NeuralCorrelationCalculator(
            field_name="q", reference_point=p2, weights_path=preset))
        scene.renderers = [{"type": "dvr", "view": 0, "field": name}]
        path = os.path.join(NEURAL_DIR, "state.json")
        scene.save_state(path, reference_format=True)
        vd.remove_calculator(name)
        with open(path) as f:
            types = [c["type"] for c in json.load(f)["calculators"]]
        assert "correlation_vmlp" in types, types
        loaded = Scene.load_state(path, volume_data=vd)
        img = loaded.render_view(0, image_size=image_size)
        got = vd.get_field(name)
        err = max_abs(got, want)
        print(f"[neural {card}] (c) reference state file with an .npz "
              f"preset: calculators {types}; loaded field vs the direct "
              f"calculator's {err:.1e} (bit for bit); frame max alpha "
              f"{float(img[..., 3].max()):.3f}")
        assert err == 0.0 and bool(torch.isfinite(img).all())
        assert float(img[..., 3].max()) > 0
        vd.remove_calculator(name)
    finally:
        shutil.rmtree(NEURAL_DIR, ignore_errors=True)
    print(f"[neural {card}] the phase {time.perf_counter() - t_phase:.1f} s")


# Phase 27.
DIAGRAMS_DIR = "build/diagrams"
# (a) Config 1's grid at downsample 16: 8 × 8 × 2 = 128 leaves, 8128
# pairs. The charts of each sampler in Pearson, and mean and plastic in
# the other measures; bars: tests/test_pallas.py:26 for Pearson, the
# rank and MI measures' card-against-CPU bars of the kernels and
# binned MI's float32 sums.
DIAGRAM_CHECK_DOWNSAMPLE = 16
DIAGRAM_CHECK_MAX_CHORDS = 100
DIAGRAM_BARS = {"pearson": 2e-5, "spearman": 2e-6, "kendall": 0.0,
                "mi_binned": 1e-5, "mi_kraskov": 1e-5,
                "binned_mi_correlation_coefficient": 1e-5,
                "kmi_correlation_coefficient": 1e-5}
DIAGRAM_CHECKS = (
    tuple((method, "pearson", 20) for method in
          ("mean", "random", "halton", "plastic"))
    + tuple((method, measure, 20) for method in ("mean", "plastic")
            for measure in ("spearman", "kendall", "mi_binned",
                            "mi_kraskov"))
    + (("bayesian", "pearson", 40),))
# The CPU's share of a chart, in pair ranges a worker process each: the
# plastic rank and MI charts take 45-75 s on one thread.
DIAGRAM_CPU_SPLITS = {("plastic", "kendall"): 6, ("plastic", "mi_binned"): 8,
                      ("plastic", "mi_kraskov"): 8}
DIAGRAM_REQUESTS = 4096
TSNE_POINTS, TSNE_ITERS = 400, 50
TS_WINDOW = 60
# (b) The JAX bench's 512-leaf HEB serves (bench.py:796-890) at the
# headline stack: downsample 32 of 250^3 gives 8^3 leaves, 130,816 pairs.
DIAGRAM_HEADLINE_DOWNSAMPLE = 32
DIAGRAM_HEADLINE_LEAVES = 512
DIAGRAM_HEADLINE_CHORDS = 250
DIAGRAM_SERVES = {"plastic": dict(sampling_method="plastic", num_samples=20),
                  "bayesian": dict(sampling_method="bayesian",
                                   num_samples=40)}

_DIAGRAM_STACK = None


def _diagram_worker_init(path: str) -> None:
    """A CPU reference worker: one thread (ROADMAP C), the stack from
    the file the parent wrote."""
    global _DIAGRAM_STACK
    torch.set_num_threads(1)
    _DIAGRAM_STACK = torch.from_numpy(np.load(path))


def _diagram_cpu_job(job):
    """One CPU reference job of phase 27 (a) in a worker process."""
    from correrender_tpu_torch.calculators.correlation import (
        correlate_requests)
    from correrender_tpu_torch.diagrams.heb import HEBChart

    kind = job[0]
    if kind == "requests":
        _, measure, req_a, req_b = job
        return correlate_requests(_DIAGRAM_STACK, req_a, req_b,
                                  measure).numpy()
    _, kw, lo, hi = job
    chart = HEBChart(_DIAGRAM_STACK, downsample_factor=DIAGRAM_CHECK_DOWNSAMPLE,
                     max_chords=DIAGRAM_CHECK_MAX_CHORDS, **kw)
    iu, ju = chart.candidate_pairs()
    return chart.pair_values(iu[lo:hi], ju[lo:hi])


def chords_match(got, want, bar: float) -> str | None:
    """None when the chord lists are the same chords in the same order,
    values within ``bar``; pairs whose magnitudes (the ranking) are within
    ``bar`` may trade places, and at the cut a pair may stand in for one
    whose magnitude it ties. Else the first difference."""
    if len(got) != len(want):
        return f"{len(got)} chords against {len(want)}"
    if not want:
        return None
    gv = np.abs([c[2] for c in got])
    wv = np.abs([c[2] for c in want])
    if np.abs(gv - wv).max() > bar:
        return f"magnitudes differ by {np.abs(gv - wv).max():.2e}"
    gd = {(i, j): v for i, j, v in got}
    wd = {(i, j): v for i, j, v in want}
    for key in gd.keys() & wd.keys():
        if abs(gd[key] - wd[key]) > bar:
            return f"pair {key}: {gd[key]} against {wd[key]}"
    for key in gd.keys() ^ wd.keys():
        v = abs(gd.get(key, wd.get(key)))
        if abs(v - wv.min()) > bar:
            return f"pair {key} ({v}) on one side only, cut {wv.min()}"
    return None


def bayesian_departures(card: str, stack, chart, flat, want, ks,
                        bar: float) -> None:
    """27 (a): the bayesian pairs where the card's GP-UCB parts from the
    CPU's. The two take other branches of a rounding tie (the refit's
    argmax over a flat likelihood, a UCB argmax; ROADMAP C): at most 2%
    of the refined pairs, and both maxima between the pair's 20 initial
    samples and its exhaustive maximum (the card's)."""
    from correrender_tpu_torch.diagrams.octree import GridRegion
    from correrender_tpu_torch.diagrams.sampling import (
        batched_block_pairs_max, exhaustive_block_pair_max)

    iu, ju, _ = chart._pair_values
    refined = min(len(iu), max(4 * chart.max_chords, int(np.ceil(
        chart.screening_top_frac * len(iu)))))
    bounds = chart._leaf_bounds()
    ra, rb = bounds[iu[ks]], bounds[ju[ks]]
    init = batched_block_pairs_max(stack, ra, rb, method="plastic",
                                   num_samples=20) if len(ks) else []
    for k, a, b, first in zip(ks, ra, rb, init):
        truth = exhaustive_block_pair_max(stack, GridRegion(*a),
                                          GridRegion(*b))
        print(f"[diagrams {card}] (a) bayesian pair {k} (leaves {iu[k]}, "
              f"{ju[k]}): card {flat[k]:.6f}, CPU {want[k]:.6f}; initial "
              f"samples {first:.6f}, exhaustive {truth:.6f}")
        assert all(first - bar <= v <= truth + 1e-5 for v in (flat[k],
                                                               want[k]))
    print(f"[diagrams {card}] (a) bayesian: {len(ks)} of {refined} refined"
          f" pairs part card from CPU (rounding ties)")
    assert len(ks) <= 0.02 * refined, len(ks)


def diagrams_config1(dev, card: str) -> None:
    """27 (a): the diagrams at config 1's grid, card against the CPU (one
    thread a process) on the same inputs."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from correrender_tpu_torch.calculators.correlation import (
        correlate_requests)
    from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
    from correrender_tpu_torch.diagrams.distribution_similarity import (
        build_features)
    from correrender_tpu_torch.diagrams.dbscan import dbscan
    from correrender_tpu_torch.diagrams.heb import HEBChart, top_chords
    from correrender_tpu_torch.diagrams.matrix import (
        field_correlation_matrix)
    from correrender_tpu_torch.diagrams.octree import downsample_fields
    from correrender_tpu_torch.diagrams.timeseries import (
        time_series_correlation)
    from correrender_tpu_torch.diagrams.tsne import tsne
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    t0 = time.perf_counter()
    (xs, ys, zs), members = CONFIG1_GRID, 100
    stack = synth_box_stack(xs, ys, zs, members,
                            torch.Generator(device=dev).manual_seed(27), dev)
    host = stack.cpu()
    os.makedirs(DIAGRAMS_DIR, exist_ok=True)
    path = os.path.join(DIAGRAMS_DIR, "stack.npy")
    np.save(path, host.numpy())
    rng = np.random.default_rng(27)
    shape = np.array([zs, ys, xs])
    req_a = rng.integers(0, shape, size=(DIAGRAM_REQUESTS, 3))
    req_b = rng.integers(0, shape, size=(DIAGRAM_REQUESTS, 3))
    # The main process mostly waits on the card and then on the workers.
    workers = max(1, min(8, os.cpu_count() or 1))
    charts = {}
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_diagram_worker_init, initargs=(path,)) as pool:
        # The CPU's jobs go first, then the card works while they run.
        futures = {}
        for method, measure, samples in DIAGRAM_CHECKS:
            kw = dict(sampling_method=method, measure=measure,
                      num_samples=samples)
            chart = HEBChart(stack, downsample_factor=DIAGRAM_CHECK_DOWNSAMPLE,
                             max_chords=DIAGRAM_CHECK_MAX_CHORDS, **kw)
            pairs = len(chart.candidate_pairs()[0])
            parts = DIAGRAM_CPU_SPLITS.get((method, measure), 1)
            edges = np.linspace(0, pairs, parts + 1).astype(int)
            futures[(method, measure)] = [
                pool.submit(_diagram_cpu_job, ("pairs", kw, lo, hi))
                for lo, hi in zip(edges[:-1], edges[1:])]
            charts[(method, measure)] = chart
        for measure in DIAGRAM_BARS:
            futures[("requests", measure)] = [pool.submit(
                _diagram_cpu_job, ("requests", measure, req_a, req_b))]
        card_s = {}
        for key, chart in charts.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            chart.compute_correlations()
            card_s[key] = time.perf_counter() - t1
        card_req = {m: correlate_requests(stack, req_a, req_b, m)
                    for m in DIAGRAM_BARS}
        cpu = {key: np.concatenate([f.result() for f in fs])
               for key, fs in futures.items()}
    os.remove(path)
    for (method, measure), chart in charts.items():
        iu, ju, flat = chart._pair_values
        want = cpu[(method, measure)]
        bar = DIAGRAM_BARS[measure]
        nan_equal = np.array_equal(np.isnan(flat), np.isnan(want))
        diff = np.where(np.isnan(flat) & np.isnan(want), 0.0,
                        np.abs(flat - want))
        departs = ~(diff <= bar)
        keep = ~np.isin(np.arange(len(flat)), np.flatnonzero(departs))
        want_chords = top_chords(iu, ju, want, chart.correlation_range,
                                 chart.max_chords)
        got_chords = chart.chords
        if method == "bayesian":
            # Departing pairs leave both chord lists (rounding ties).
            drop = {(int(iu[k]), int(ju[k])) for k in np.flatnonzero(departs)}
            got_chords = [c for c in got_chords if c[:2] not in drop]
            want_chords = [c for c in want_chords if c[:2] not in drop]
        problem = chords_match(got_chords, want_chords, bar)
        print(f"[diagrams {card}] (a) HEB {method} {measure} "
              f"({chart.num_leaves} leaves, {len(flat)} pairs): card "
              f"{card_s[(method, measure)]:.3f} s; pair values max|card - "
              f"cpu| {diff[keep].max():.3e} (bar {bar}); {len(chart.chords)}"
              f" chords, same as the CPU's: {problem is None}"
              + (f"; {int(departs.sum())} pairs depart" if method ==
                 "bayesian" else ""))
        assert nan_equal, (method, measure)
        assert problem is None, (method, measure, problem)
        if method == "bayesian":
            bayesian_departures(card, stack, chart, flat, want,
                                np.flatnonzero(departs), bar)
        else:
            assert not departs.any(), (method, measure, diff.max())
    for measure, got in card_req.items():
        pair = [got.cpu().double(),
                torch.from_numpy(cpu[("requests", measure)]).double()]
        what = ""
        if measure.endswith("correlation_coefficient"):
            # c = sqrt(1 − exp(−2·MI)) has an infinite slope at MI = 0, and
            # its inverse MI = −½·log(1 − c²) one at c = 1: a pair is held
            # on the scale where it is well conditioned, c or the MI.
            assert torch.equal(*(torch.isnan(c) for c in pair)), measure
            d_c = torch.nan_to_num((pair[0] - pair[1]).abs())
            mi = [-0.5 * torch.log1p(-c * c) for c in pair]
            d_mi = (mi[0] - mi[1]).abs()
            pair = [torch.minimum(d_c, torch.nan_to_num(d_mi, nan=np.inf)),
                    torch.zeros_like(d_c)]
            what = " (on c or the MI)"
        err = max_abs(*pair)
        print(f"[diagrams {card}] (a) correlate_requests {measure}, "
              f"{DIAGRAM_REQUESTS} pairs: max|card - cpu|{what} {err:.3e} "
              f"(bar {DIAGRAM_BARS[measure]})")
        assert err <= DIAGRAM_BARS[measure], (measure, err)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see ROADMAP C
    try:
        # The field-correlation matrix of two fields of the grid.
        grid = GridMetadata(xs=xs, ys=ys, zs=zs, es=members)
        mats = []
        for device, data in ((dev, stack), ("cpu", host)):
            vd = VolumeData(grid, device=device)
            vd.add_field("q", lambda t, e, d=data: d[..., e])
            vd.add_field("q_shift", lambda t, e, d=data: d[
                ..., (e + 1) % members])
            mats.append(field_correlation_matrix(vd)[0])
        err = max_abs(mats[0].cpu(), mats[1])
        print(f"[diagrams {card}] (a) field_correlation_matrix (2 fields, "
              f"1024 voxels): max|card - cpu| {err:.3e} (bar 2e-5)")
        assert err <= 2e-5
        # Distribution similarity, 400 points: features, the initial
        # embedding, one step; after 50 iterations the two runs are
        # printed (t-SNE's step is unstable at this size: ROADMAP C).
        feats = [build_features(s, max_points=TSNE_POINTS)[0]
                 for s in (stack, host)]
        err = max_abs(feats[0].cpu(), feats[1])
        assert err == 0.0, err
        embs = {}
        for iters in (0, 1, TSNE_ITERS):
            embs[iters] = [tsne(f, num_iters=iters).cpu() for f in feats]
        init_equal = torch.equal(*embs[0])
        one = max_abs(*embs[1])
        fifty = max_abs(*embs[TSNE_ITERS])
        labels = []
        for emb in embs[TSNE_ITERS]:
            e = emb.numpy()
            eps = 0.05 * float(np.linalg.norm(e.max(0) - e.min(0)))
            labels.append(dbscan(e, eps=eps, min_samples=8))
        agree = float((labels[0] == labels[1]).mean())
        print(f"[diagrams {card}] (a) distribution similarity, "
              f"{len(feats[0])} points: features equal; initial embedding "
              f"equal to the bit: {init_equal}; after 1 iteration max|card "
              f"- cpu| {one:.3e} (bar 1e-4); after {TSNE_ITERS} iterations "
              f"{fifty:.3e} of a {float(embs[TSNE_ITERS][1].abs().max()):.1f}"
              f" embedding, DBSCAN labels equal at {agree:.3f} of the points"
              f" (not asserted: ROADMAP C)")
        assert init_equal and one <= 1e-4
        # Time series: the 128 block-mean series of the grid.
        series = [downsample_fields(s, DIAGRAM_CHECK_DOWNSAMPLE).reshape(
            -1, members) for s in (stack, host)]
        for window in (None, TS_WINDOW):
            got, want = (time_series_correlation(s, window=window)
                         for s in series)
            err = max_abs(got.cpu(), want)
            print(f"[diagrams {card}] (a) time_series_correlation "
                  f"{'pairwise' if window is None else f'lag, window {window}'}"
                  f" {tuple(got.shape)}: max|card - cpu| {err:.3e} (bar 2e-5)")
            assert err <= 2e-5
    finally:
        torch.set_num_threads(threads)
    print(f"[diagrams {card}] (a) {time.perf_counter() - t0:.1f} s "
          f"({workers} CPU worker processes of one thread)")


def phase_diagrams(dev, card: str, vd, name: str) -> None:
    """27. The diagrams (see the module docstring)."""
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.diagrams.heb import HEBChart
    from correrender_tpu_torch.diagrams.matrix import (
        field_correlation_matrix)
    from correrender_tpu_torch.diagrams import raster
    from correrender_tpu_torch.diagrams.raster import (
        composite_overlay, rasterize_svg)
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.render.camera import Camera

    t_phase = time.perf_counter()
    diagrams_config1(dev, card)
    side, members = vd.grid.xs, vd.grid.es
    mstack = vd.get_member_stack("q")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for label, kw in DIAGRAM_SERVES.items():
        t0 = time.perf_counter()
        chart = HEBChart(mstack, downsample_factor=DIAGRAM_HEADLINE_DOWNSAMPLE,
                         max_chords=DIAGRAM_HEADLINE_CHORDS, **kw)
        build_s = time.perf_counter() - t0
        pairs = chart.num_leaves * (chart.num_leaves - 1) // 2
        assert chart.num_leaves == DIAGRAM_HEADLINE_LEAVES, chart.num_leaves
        chart.compute_correlations()  # warm-up
        times = []
        for _ in range(3 if label == "plastic" else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chart.compute_correlations()
            times.append(time.perf_counter() - t0)
        print(f"[diagrams {card}] (b) HEB {label} serve at {side}^3 x "
              f"{members}: {chart.num_leaves} leaves, {pairs} pairs, "
              f"{kw['num_samples']} samples: compute_correlations "
              f"{statistics.median(times):.3f} s ("
              + ("median of 3" if len(times) > 1 else "one run")
              + f" after a warm-up; host clock, the values' copy to the "
              f"host included); the chart's means and ring {build_s:.3f} s;"
              f" {len(chart.chords)} chords, the strongest "
              f"{chart.chords[0][2]:.4f}")
        assert len(chart.chords) == DIAGRAM_HEADLINE_CHORDS
        del chart
    # The Scene: dvr and a diagram node in view 0, at 1920x1080.
    image_size = HEADLINE_IMAGE
    p1 = (side // 4, side // 4, side // 2)
    p2 = (side // 4 + 3, side // 4, side // 2)
    calc = vd.calculators[name]
    cam, cam2 = config1_camera(), Camera(position=(0.08, 0.27, 0.86))
    scene = Scene(vd, [cam, cam2])
    scene.transfer_functions[name] = config1_transfer_function(dev)
    for label, kw in DIAGRAM_SERVES.items():
        node = {"type": "diagram", "view": 0, "field": "q",
                "downsample": DIAGRAM_HEADLINE_DOWNSAMPLE,
                "max_chords": DIAGRAM_HEADLINE_CHORDS, **kw}
        scene.renderers = [{"type": "dvr", "view": 0, "field": name}, node]
        calc.set_reference_point(*p1)
        plain = scene.render_view(0, image_size=image_size,
                                  show_diagram_overlays=False)
        torch.cuda.synchronize()
        # The first frame, its parts timed where the Scene calls them:
        # the chart and its SVG, then the rasterization.
        parts = {}

        def timed(part, fn):
            def run(*args, **kwargs):
                t1 = time.perf_counter()
                out = fn(*args, **kwargs)
                parts[part] = time.perf_counter() - t1
                return out
            return run

        scene.render_diagram = timed("svg", scene.render_diagram)
        raster.rasterize_svg = timed("raster", rasterize_svg)
        try:
            t0 = time.perf_counter()
            first = scene.render_view(0, image_size=image_size)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        finally:
            del scene.render_diagram
            raster.rasterize_svg = rasterize_svg
        overlays = list(scene._overlay_cache.values())
        assert overlays and all(isinstance(o, torch.Tensor)
                                for o in overlays), "an overlay was dropped"
        overlay = overlays[-1]
        svg_s, raster_s = parts["svg"], parts["raster"]
        comp_ms = median_ms(lambda: composite_overlay(plain, overlay))
        # Cached-overlay frames against plain frames, the reference point
        # moved each frame (K1, K2, K3 once a frame).
        again = scene.render_view(0, image_size=image_size)
        assert torch.equal(again, first), "a cached frame differs"
        h, w = overlay.shape[:2]
        inside = torch.zeros(first.shape[:2], dtype=torch.bool, device=dev)
        inside[-8 - h:-8, -8 - w:] = True
        assert torch.equal(first[~inside], plain[~inside])
        assert float((first - plain).abs()[inside].max()) > 0.3
        moves = iter(range(10**6))

        def frame(show):
            calc.set_reference_point(*(p2 if next(moves) % 2 else p1))
            return scene.render_view(0, image_size=image_size,
                                     show_diagram_overlays=show)

        frame(True)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        frame(True)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        assert all(launches.get(k, 0) >= 1 for k in FAST_PATH), launches
        cached_ms = median_ms(lambda: frame(True))
        plain_ms = median_ms(lambda: frame(False))
        print(f"[diagrams {card}] (b) Scene {label} overlay at "
              f"{image_size[0]}x{image_size[1]}: first frame {first_s:.3f} s"
              f" (the chart and its SVG {svg_s:.3f} s, rasterizing "
              f"{w}x{h} {raster_s:.3f} s, composite {comp_ms:.3f} ms; host "
              f"clock); the point-move frame with the cached overlay "
              f"{cached_ms:.3f} ms against {plain_ms:.3f} ms without "
              f"(median of 5 each); launches a frame {launches}; overlay "
              f"rendered, frames differ only in its {w}x{h} rectangle")
    # The field-correlation matrix of two fields of the headline grid.
    vd.add_field("q_shift", lambda t, e: mstack[..., (e + 1) % members])
    field_correlation_matrix(vd, ["q", "q_shift"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, _ = field_correlation_matrix(vd, ["q", "q_shift"])
    torch.cuda.synchronize()
    matrix_s = time.perf_counter() - t0
    assert bool(torch.isfinite(m).all())
    print(f"[diagrams {card}] (b) field_correlation_matrix of 2 fields at "
          f"{side}^3 x {members}: {matrix_s * 1e3:.3f} ms (cached member "
          f"stacks; host clock); off-diagonal {float(m[0, 1]):.4f}")
    # The dock: view 0 (dvr and the plastic chart), view 1 (dvr).
    scene.renderers = [
        {"type": "dvr", "view": 0, "field": name},
        {"type": "diagram", "view": 0, "field": "q",
         "downsample": DIAGRAM_HEADLINE_DOWNSAMPLE,
         "max_chords": DIAGRAM_HEADLINE_CHORDS,
         **DIAGRAM_SERVES["plastic"]},
        {"type": "dvr", "view": 1, "field": name}]
    scene.dock_layout = [[0, 1]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dock = scene.render_dock(image_size=image_size)
    torch.cuda.synchronize()
    dock_first_s = time.perf_counter() - t0
    dock_ms = median_ms(lambda: scene.render_dock(image_size=image_size))
    half = image_size[0] // 2
    assert dock.shape == (image_size[1], image_size[0], 4)
    assert torch.equal(dock[:, half:], scene.render_view(
        1, image_size=(half, image_size[1])))
    assert all(isinstance(o, torch.Tensor)
               for o in scene._overlay_cache.values())
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[diagrams {card}] (b) render_dock of 2 views at "
          f"{image_size[0]}x{image_size[1]}: first {dock_first_s:.3f} s "
          f"(a new overlay size), then {dock_ms:.3f} ms (median of 5); peak"
          f" max_memory_allocated {peak / 2**30:.2f} GiB (the headline "
          f"stack and the earlier phases' cache included)")
    print(f"[diagrams {card}] the phase {time.perf_counter() - t_phase:.1f} s")


TFOPT_DIR = "build/tfopt"
TFOPT_SEED = 28
TFOPT_TF_SIZE = 64  # optimize_tf_ols' and optimize_tf_gd's default R
TFOPT_DENSE = ("cholesky", "lu", "qr", "svd")
TFOPT_ITERATIVE = ("cgls", "lsqr")
TFOPT_GD_EPOCHS = 200
TFOPT_DIFFDVR_EPOCHS = 3
TFOPT_DIFFDVR_IMAGE = (64, 64)
TFOPT_DIFFDVR_DEFAULT_EPOCHS = 60  # optimize_tf_diffdvr's default
ISO_MESH_VALUE = 0.5
# Card against CPU on the same fields. The LUTs of the Cholesky, LU and
# QR solves, NNLS and GD within the CPU tests' LUT bar against JAX. The
# normal equations at config 1's grid are singular (bins of B's range
# that no voxel fills), so the SVD cutoff and 200 float32 iterations of
# CGLS or LSQR settle differently along the near-null directions with
# the summation order (a voxel permutation on the CPU moved their LUTs by
# 4e-3 to 9e-2): those three are held by the fit's voxel loss instead,
# within 1e-4 relative (the permutation moved it by 2e-7 to 1.3e-5).
# DiffDVR's gradient, at the same LUT on both, within 1e-4 of its
# largest entry (the card's LUT gather backward adds with atomics).
ATOL_TFOPT_LUT = 1e-4
RTOL_TFOPT_LOSS = 1e-4
TFOPT_BY_LOSS = ("svd", "cgls", "lsqr")
RTOL_DIFFDVR_GRAD = 1e-4
RTOL_LPIPS = 1e-5
ATOL_LPIPS_GOLDEN = 1e-4  # tests/test_lpips.py


def _tfopt_inputs(path: str):
    from correrender_tpu_torch.render.tf import TransferFunction

    with np.load(path) as f:
        a, b = torch.from_numpy(f["a"]), torch.from_numpy(f["b"])
        tf_a = TransferFunction(lut=torch.from_numpy(f["lut_a"]),
                                domain=tuple(float(v) for v in f["domain_a"]))
        domain_b = tuple(float(v) for v in f["domain_b"])
    return a, b, tf_a, domain_b


def _tfopt_cpu_job(job):
    """28 (a): one CPU fit of the card's inputs, in a spawned process of
    one thread (ROADMAP C: the CPU reference runs single-threaded).
    ``cfg`` carries the sizes, so a process sees its parent's."""
    torch.set_num_threads(1)
    from correrender_tpu_torch.app.baseline_configs import config1_camera
    from correrender_tpu_torch.optim import tf_opt

    kind, path, extra, cfg = job
    t0 = time.perf_counter()
    out = {}
    if kind == "render":
        from correrender_tpu_torch.app import cli

        cli.main(extra)
        return kind, out, time.perf_counter() - t0
    a, b, tf_a, domain_b = _tfopt_inputs(path)
    size, image = cfg["tf_size"], cfg["image"]
    if kind == "dense":
        for solver in TFOPT_DENSE:
            out[solver] = tf_opt.optimize_tf_ols(
                a, tf_a, b, size, solver=solver, nonneg=False).lut.numpy()
        out["nonneg"] = tf_opt.optimize_tf_ols(a, tf_a, b, size).lut.numpy()
        out["gd"] = tf_opt.optimize_tf_gd(
            a, tf_a, b, size, epochs=cfg["gd_epochs"]).lut.numpy()
    elif kind in TFOPT_ITERATIVE:
        out[kind] = tf_opt.optimize_tf_ols(a, tf_a, b, size,
                                           solver=kind).lut.numpy()
    elif kind == "diffdvr_fit":
        out["diffdvr"] = tf_opt.optimize_tf_diffdvr(
            a, tf_a, b, config1_camera(), epochs=cfg["epochs"],
            image_size=image).lut.numpy()
    elif kind == "diffdvr_grads":
        from correrender_tpu_torch.render.dvr import dvr_render

        with torch.no_grad():
            target = dvr_render(a, config1_camera(), tf_a, image_size=image)
        out["grads"] = [tf_opt.diffdvr_grad(
            torch.from_numpy(lut), b, target, config1_camera(), domain_b,
            image)[1].numpy() for lut in extra]
    return kind, out, time.perf_counter() - t0


def tfopt_config1(dev, card: str) -> None:
    """28 (a): TF optimization, LPIPS, the histogram and the CLI at config
    1's grid, card against the CPU on the same inputs."""
    import multiprocessing
    import os
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    from correrender_tpu_torch.app import cli
    from correrender_tpu_torch.app.baseline_configs import config1_camera
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.io import writers
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.optim import tf_opt
    from correrender_tpu_torch.render.tf import TransferFunction
    from correrender_tpu_torch.utils import histogram, lpips_alex, metrics
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    t0 = time.perf_counter()
    (xs, ys, zs), members = CONFIG1_GRID, 100
    stack = synth_box_stack(xs, ys, zs, members,
                            torch.Generator(device=dev).manual_seed(
                                TFOPT_SEED), dev)
    point = (xs // 4, ys // 4, zs // 2)  # config 1's, the first box's centre
    ref = stack[point[2], point[1], point[0]]
    _build.reset_launch_counts()
    field_a = correlate_field(stack, ref, "pearson")
    field_b = correlate_field(stack, ref, "spearman")
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert launches == {"pearson": 1, "spearman": 1}, launches
    domain_a = tuple(torch.stack(histogram.min_max(field_a)).tolist())
    domain_b = tuple(torch.stack(histogram.min_max(field_b)).tolist())
    tf_a = TransferFunction.from_colormap("coolwarm", domain=domain_a,
                                          device=dev)
    os.makedirs(TFOPT_DIR, exist_ok=True)
    inputs = os.path.join(TFOPT_DIR, "inputs.npz")
    np.savez(inputs, a=field_a.cpu().numpy(), b=field_b.cpu().numpy(),
             lut_a=tf_a.lut.cpu().numpy(), domain_a=np.array(domain_a),
             domain_b=np.array(domain_b))
    nc = os.path.join(TFOPT_DIR, "config1.nc")
    writers.write_netcdf(nc, stack.permute(3, 0, 1, 2).cpu().numpy()[:, None],
                         name="q")
    del stack
    render_args = ["render", "--dataset", nc, "--measure", "pearson",
                   "--ref", ",".join(map(str, point)), "--size",
                   "x".join(map(str, CONFIG1_IMAGE))]
    png = {d: os.path.join(TFOPT_DIR, f"render_{d}.png")
           for d in ("cuda", "cpu")}
    # The CLI's HTML log goes under build/ (the workers inherit it).
    saved_config = os.environ.get("CORRERENDER_CONFIG_DIR")
    os.environ["CORRERENDER_CONFIG_DIR"] = os.path.join(TFOPT_DIR, "config")
    workers = max(1, min(6, os.cpu_count() or 1))
    cpu = {}
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cfg = dict(tf_size=TFOPT_TF_SIZE, image=TFOPT_DIFFDVR_IMAGE,
                   epochs=TFOPT_DIFFDVR_EPOCHS, gd_epochs=TFOPT_GD_EPOCHS)
        futures = [pool.submit(_tfopt_cpu_job, (kind, inputs, None, cfg))
                   for kind in ("cgls", "lsqr", "dense", "diffdvr_fit")]
        futures.append(pool.submit(_tfopt_cpu_job, (
            "render", None, render_args + ["--device", "cpu", "--output",
                                           png["cpu"]], cfg)))
        # The card's fits while the CPU's run.
        lut = {}
        for solver in TFOPT_DENSE + TFOPT_ITERATIVE:
            lut[solver] = tf_opt.optimize_tf_ols(
                field_a, tf_a, field_b, TFOPT_TF_SIZE, solver=solver,
                nonneg=False).lut.cpu().numpy()
        lut["nonneg"] = tf_opt.optimize_tf_ols(
            field_a, tf_a, field_b, TFOPT_TF_SIZE).lut.cpu().numpy()
        lut["gd"] = tf_opt.optimize_tf_gd(
            field_a, tf_a, field_b, TFOPT_TF_SIZE,
            epochs=TFOPT_GD_EPOCHS).lut.cpu().numpy()
        # Each epoch's gradient at the card's LUT of that epoch: the CPU
        # takes it at the same LUT, a job an epoch, while the card goes on.
        grads, losses, grad_jobs = [], [], []

        def on_epoch(i, value, at, grad):
            grads.append(grad.cpu().numpy())
            losses.append(float(value))
            grad_jobs.append(pool.submit(_tfopt_cpu_job, (
                "diffdvr_grads", inputs, [at.cpu().numpy()], cfg)))

        lut["diffdvr"] = tf_opt.optimize_tf_diffdvr(
            field_a, tf_a, field_b, config1_camera(),
            epochs=TFOPT_DIFFDVR_EPOCHS, image_size=TFOPT_DIFFDVR_IMAGE,
            on_epoch=on_epoch).lut.cpu().numpy()
        # The histogram, LPIPS and the CLI frame on the card.
        counts, _ = histogram.histogram(field_a, normalize=False)
        want, _ = histogram.histogram(field_a.cpu(), normalize=False)
        assert torch.equal(counts.cpu(), want), "histogram counts differ"
        with open("tests/goldens/lpips_golden.json") as f:
            golden = json.load(f)
        rng = np.random.default_rng(golden["seed_inputs"])
        shape = tuple(golden["shape"])
        img_a = rng.random(shape).astype(np.float32)
        img_b = np.clip(img_a + 0.1 * rng.standard_normal(shape), 0,
                        1).astype(np.float32)
        pairs = {"near": (img_a, img_b),
                 "invert": (img_a, (1.0 - img_a).astype(np.float32)),
                 "gray_vs_a": (np.full(shape, 0.5, np.float32), img_a)}
        params = lpips_alex.synthetic_lpips_params(golden["seed_weights"])
        lp = {d: lpips_alex.params_to_device(params, d) for d in (dev, "cpu")}
        lpips_err = []
        for case, (x, y) in pairs.items():
            got = lpips_alex.lpips_alex(x, y, lp[dev])
            cpu_d = lpips_alex.lpips_alex(x, y, lp["cpu"])
            want_d = golden["cases"][case]["distance"]
            assert abs(got - want_d) <= ATOL_LPIPS_GOLDEN, (case, got, want_d)
            assert abs(got - cpu_d) <= RTOL_LPIPS * cpu_d, (case, got, cpu_d)
            lpips_err.append((case, got, abs(got - cpu_d) / cpu_d,
                              abs(got - want_d)))
        r_card = metrics.lpips_random(img_a, img_b, device=dev)
        r_cpu = metrics.lpips_random(img_a, img_b, device="cpu")
        assert abs(r_card - r_cpu) <= RTOL_LPIPS * r_cpu, (r_card, r_cpu)
        _build.reset_launch_counts()
        cli.main(render_args + ["--device", str(dev), "--output",
                                png["cuda"]])
        torch.cuda.synchronize()
        cli_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        assert all(cli_launches.get(k, 0) >= 1 for k in FAST_PATH), \
            cli_launches
        card_s = time.perf_counter() - t0
        for fut in futures:
            kind, out, secs = fut.result()
            cpu.update(out)
            cpu[f"{kind}_s"] = secs
        cpu["grads"] = [fut.result()[1]["grads"][0] for fut in grad_jobs]
    # The comparisons.
    from PIL import Image

    from correrender_tpu_torch.utils.metrics import ssim

    # The voxel loss of a LUT, from the normal equations in float64.
    ata, atb, btb = (v.double() for v in tf_opt._normal_equations(
        field_a.reshape(-1).cpu(), field_b.reshape(-1).cpu(),
        TransferFunction(lut=tf_a.lut.cpu(), domain=tf_a.domain), domain_b,
        TFOPT_TF_SIZE))
    empty = int((torch.diag(ata) == 0).sum())

    def voxel_loss(x):
        x = torch.from_numpy(x).double()
        return float(((x * (ata @ x)).sum() - 2 * (x * atb).sum()
                      + btb.sum()) / field_a.numel() / 4)

    errs = {}
    for k in TFOPT_DENSE + TFOPT_ITERATIVE + ("nonneg", "gd", "diffdvr"):
        errs[k] = float(np.abs(lut[k] - cpu[k]).max())
    loss_errs = {k: abs(voxel_loss(lut[k]) - voxel_loss(cpu[k]))
                 / voxel_loss(cpu[k]) for k in TFOPT_BY_LOSS}
    grad_errs = [float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30))
                 for g, c in zip(grads, cpu["grads"])]
    frames = {d: np.asarray(Image.open(p), np.float32) / 255.0
              for d, p in png.items()}
    frame_err = float(np.abs(frames["cuda"] - frames["cpu"]).max())
    frame_ssim = ssim(frames["cuda"], frames["cpu"])
    print(f"[tfopt {card}] (a) config 1's grid {xs}x{ys}x{zs} x {members}: "
          f"field A Pearson (K1), B Spearman (B7), launches {launches}; "
          f"R = {TFOPT_TF_SIZE}, {empty} bins of B's range empty")
    print(f"[tfopt {card}] (a) LUT card vs CPU (one thread), max-abs: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bar {ATOL_TFOPT_LUT} but for {', '.join(TFOPT_BY_LOSS)} and "
          f"DiffDVR's {TFOPT_DIFFDVR_EPOCHS} free-running epochs, not held);"
          f" voxel loss card vs CPU, relative: "
          + ", ".join(f"{k} {v:.3e}" for k, v in loss_errs.items())
          + f" (bar {RTOL_TFOPT_LOSS})")
    print(f"[tfopt {card}] (a) DiffDVR at {TFOPT_DIFFDVR_IMAGE[0]}x"
          f"{TFOPT_DIFFDVR_IMAGE[1]}: losses {[round(v, 6) for v in losses]}; "
          f"each epoch's gradient at the card's LUT, card vs CPU relative "
          f"{[f'{e:.3e}' for e in grad_errs]} (bar {RTOL_DIFFDVR_GRAD})")
    print(f"[tfopt {card}] (a) histogram of A (256 bins) counts equal; "
          f"lpips_alex on the golden weights (case, card, card vs CPU "
          f"relative, card vs golden): {lpips_err} (bars {RTOL_LPIPS}, "
          f"{ATOL_LPIPS_GOLDEN}); lpips_random card {r_card:.6f}, CPU "
          f"{r_cpu:.6f}")
    print(f"[tfopt {card}] (a) cli render --device {dev} at "
          f"{CONFIG1_IMAGE[0]}x{CONFIG1_IMAGE[1]}: launches {cli_launches}; "
          f"PNG vs --device cpu max-abs {frame_err:.3e} (bar "
          f"{MAX_ABS_FRAME}), SSIM {frame_ssim:.6f} (bar {MIN_SSIM_FRAME})")
    print(f"[tfopt {card}] (a) card {card_s:.1f} s; the CPU's jobs "
          + ", ".join(f"{k[:-2]} {v:.1f} s" for k, v in cpu.items()
                      if k.endswith("_s"))
          + " (each epoch's gradient a job of about "
          f"{statistics.mean(f.result()[2] for f in grad_jobs):.1f} s) in "
          f"{workers} one-thread workers; (a) "
          f"{time.perf_counter() - t0:.1f} s")
    for k in ("cholesky", "lu", "qr", "nonneg", "gd"):
        assert errs[k] <= ATOL_TFOPT_LUT, (k, errs[k])
    for k in TFOPT_BY_LOSS:
        assert loss_errs[k] <= RTOL_TFOPT_LOSS, (k, loss_errs[k])
    assert all(e <= RTOL_DIFFDVR_GRAD for e in grad_errs), grad_errs
    assert frame_err <= MAX_ABS_FRAME and frame_ssim >= MIN_SSIM_FRAME
    assert losses[-1] < losses[0], losses
    shutil.rmtree(TFOPT_DIR)
    if saved_config is None:
        os.environ.pop("CORRERENDER_CONFIG_DIR")
    else:
        os.environ["CORRERENDER_CONFIG_DIR"] = saved_config


def timed_median(fn, reps: int = 3) -> float:
    """Median host-clock seconds of ``fn()`` (synchronized) after a
    warm-up: the fits read the device (their domains) on the way."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_tfopt(dev, card: str, vd, name: str) -> None:
    """28. TF optimization, the metrics, the mesh and the perf sweep (see
    the module docstring)."""
    from correrender_tpu_torch.app.baseline_configs import (
        config1_camera, config1_transfer_function)
    from correrender_tpu_torch.app.perf import (
        PerfState, default_perf_states, run_perf_sweep)
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.calculators.correlation import correlate_field
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.optim import tf_opt
    from correrender_tpu_torch.render.camera import default_render_box
    from correrender_tpu_torch.render.dvr import (
        dvr_render, num_steps_for, world_step_size)
    from correrender_tpu_torch.render.mesh import extract_isosurface

    t_phase = time.perf_counter()
    tfopt_config1(dev, card)
    side, members = vd.grid.xs, vd.grid.es
    calc = vd.calculators[name]
    field_a = vd.get_field(name)
    mstack = vd.get_member_stack("q")
    x, y, z = calc.reference_point
    field_b = correlate_field(mstack, mstack[z, y, x], "spearman")
    tf_a = config1_transfer_function(dev)
    voxels = field_a.numel()
    slabs = -(-voxels // (tf_opt._DENSE_WEIGHT_ELEMS // TFOPT_TF_SIZE))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ols_s = timed_median(lambda: tf_opt.optimize_tf_ols(
        field_a, tf_a, field_b, TFOPT_TF_SIZE, nonneg=False))
    ols_peak = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    gd_s = timed_median(lambda: tf_opt.optimize_tf_gd(
        field_a, tf_a, field_b, TFOPT_TF_SIZE, epochs=TFOPT_GD_EPOCHS))
    gd_peak = torch.cuda.max_memory_allocated(dev) - base
    print(f"[tfopt {card}] (b) {side}^3 x {members}, field A the Pearson "
          f"calculator's (reference {calc.reference_point}), B its Spearman "
          f"field; {voxels} voxels in {slabs} slabs at R = {TFOPT_TF_SIZE}: "
          f"optimize_tf_ols (cholesky) {ols_s * 1e3:.3f} ms, peak +"
          f"{ols_peak / 2**30:.3f} GiB; optimize_tf_gd ({TFOPT_GD_EPOCHS} "
          f"epochs, Adam) {gd_s * 1e3:.3f} ms, peak +{gd_peak / 2**30:.3f} "
          f"GiB (median of 3 after a warm-up; host clock, synchronized)")
    # DiffDVR on field B: each epoch timed (host clock; the loss and the
    # domain read the device).
    cam = config1_camera()
    box = default_render_box(field_a.shape)  # dvr_render's, as the fit's
    steps = num_steps_for(box[0], box[1], world_step_size(
        field_a.shape, box[0], box[1], 0.1))
    stamps, losses = [], []

    def on_epoch(i, value, lut, grad):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(value))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        target = dvr_render(field_a, cam, tf_a, image_size=TFOPT_DIFFDVR_IMAGE)
    torch.cuda.synchronize()
    target_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit = tf_opt.optimize_tf_diffdvr(
        field_a, tf_a, field_b, cam, epochs=TFOPT_DIFFDVR_EPOCHS,
        image_size=TFOPT_DIFFDVR_IMAGE, on_epoch=on_epoch)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    diff_peak = torch.cuda.max_memory_allocated(dev) - base
    # An epoch is the gradient and the Adam step: the gradients end at the
    # stamps; the fit's own target render comes before the first.
    epochs = np.diff([t0 + target_s] + stamps)
    later = float(np.mean(epochs[1:]))
    final = tf_opt.diffdvr_loss(fit.lut, field_b, target, cam,
                                fit.domain, TFOPT_DIFFDVR_IMAGE)
    print(f"[tfopt {card}] (b) DiffDVR on B at {TFOPT_DIFFDVR_IMAGE[0]}x"
          f"{TFOPT_DIFFDVR_IMAGE[1]}, voxel step 0.1 (about {steps} march "
          f"steps): the target {target_s:.3f} s; epoch 1 {epochs[0]:.3f} s, "
          f"epochs 2-{TFOPT_DIFFDVR_EPOCHS} {later:.3f} s each (host clock, "
          f"synchronized); {TFOPT_DIFFDVR_EPOCHS} epochs {fit_s:.3f} s; loss "
          f"{losses[0]:.6f} -> {float(final):.6f}; peak +"
          f"{diff_peak / 2**30:.3f} GiB; a fit at the default "
          f"{TFOPT_DIFFDVR_DEFAULT_EPOCHS} epochs estimated "
          f"{TFOPT_DIFFDVR_DEFAULT_EPOCHS * later:.1f} s "
          f"({TFOPT_DIFFDVR_DEFAULT_EPOCHS} x the mean later epoch, not run)")
    assert float(final) < losses[0], (float(final), losses)
    del target, fit
    t0 = time.perf_counter()
    verts, tris = extract_isosurface(field_a, ISO_MESH_VALUE)
    mesh_s = time.perf_counter() - t0
    assert len(tris) > 0 and np.isfinite(verts).all()
    print(f"[tfopt {card}] (b) extract_isosurface of A at {ISO_MESH_VALUE}: "
          f"{len(verts)} vertices, {len(tris)} triangles, {mesh_s:.2f} s "
          f"(the copy to the host, the g++ library's march, dedupe)")
    del field_b, mstack
    # The perf sweep: the default full tier's 1920x1080 states on the
    # Pearson field, and an exact iso state (the Scene's iso_ray default
    # is the fast scan, which launches no kernel).
    states = [s for s in default_perf_states(full=True, fields=[name])
              if s.image_size == HEADLINE_IMAGE]
    states.append(PerfState(f"iso_ray_exact_{HEADLINE_IMAGE[0]}x"
                            f"{HEADLINE_IMAGE[1]}", renderer="iso_ray",
                            image_size=HEADLINE_IMAGE, field=name,
                            settings={"quality": "exact"}))
    scene = Scene(vd, [cam])
    scene.transfer_functions[name] = tf_a
    rows = []
    for state in states:
        _build.reset_launch_counts()
        row, = run_perf_sweep(scene, [state])
        torch.cuda.synchronize()
        row["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
        rows.append(row)
        print(f"[tfopt {card}] (b) perf {row}")
    assert rows[0]["launches"].get("shearwarp_composite", 0) >= 1, rows[0]
    assert rows[-1]["launches"].get("raymarch_iso", 0) >= 1, rows[-1]
    print(f"[tfopt {card}] the phase {time.perf_counter() - t_phase:.1f} s")



VIEWER_DIR = "build/viewer"
VIEWER_CHECK_IMAGE = (320, 180)  # (a): the CPU server renders it too
VIEWER_TESTS_GRID, VIEWER_TESTS_MEMBERS = (16, 16, 8), 16  # the tests' scene
VIEWER_TESTS_IMAGE = (96, 72)
VIEWER_MOVES = 5
VIEWER_TFOPT_SIZE = 64
VIEWER_FLOAT_BAR = 1e-4  # tests/test_torch_port_viewer.py's FLOAT_BAR
VIEWER_SVG_ATOL = 1e-3  # SVG numbers: pixel places and printed values
VIEWER_TIMING = ("render_ms", "overlay_ms", "encode_ms", "total_ms")
VIEWER_MEASURES = ("pearson", "spearman", "kendall", "mi_binned",
                   "mi_kraskov", "binned_mi_correlation_coefficient",
                   "kmi_correlation_coefficient")


def decode_png(data: bytes) -> np.ndarray:
    """The port's PNGs (8-bit, filter 0 rows) as float32 in [0, 1]."""
    import zlib

    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            header = data[pos + 8:pos + 8 + length]
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h = (int.from_bytes(header[i:i + 4], "big") for i in (0, 4))
    channels = {2: 3, 6: 4}[header[9]]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * channels)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, channels).astype(np.float32) / 255.0


class ViewerClient:
    """A port viewer server on a free loopback port, and its client."""

    def __init__(self, scene, image_size):
        import threading

        from correrender_tpu_torch.app.viewer import make_server

        self.server, self.app = make_server(scene, port=0,
                                            image_size=image_size)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = "http://%s:%d" % self.server.server_address

    def request(self, path, cmd=None, ctype="application/json"):
        """(status, content type, body, headers); HTTP errors included."""
        import urllib.error
        import urllib.request

        req = self.base + path
        if cmd is not None:
            req = urllib.request.Request(
                req, data=json.dumps(cmd).encode(), method="POST",
                headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, r.headers["Content-Type"], r.read(), r.headers
        except urllib.error.HTTPError as e:
            return e.code, e.headers["Content-Type"], e.read(), e.headers

    def api(self, cmd: dict) -> dict:
        status, _, body, _ = self.request("/api", cmd)
        assert status == 200, (cmd, status, body)
        return json.loads(body)

    def frame(self):
        """``(png, X-Server-Frame-Ms)``; an HTTP 500 fails the phase."""
        status, ctype, body, headers = self.request("/frame")
        assert status == 200 and ctype == "image/png", (status, body[:300])
        return body, float(headers["X-Server-Frame-Ms"])

    def image(self) -> np.ndarray:
        return decode_png(self.frame()[0])

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


def viewer_replies_equal(got, want, path="reply"):
    """Equal JSON replies but for the timing fields and float rounding."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, got, want)
        for k in want:
            if k in VIEWER_TIMING:
                assert got[k] >= 0.0, (path, k, got[k])
            elif k == "chords":
                viewer_chords_equal(got[k], want[k])
            else:
                viewer_replies_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got)
        for i, (g, w) in enumerate(zip(got, want)):
            viewer_replies_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert (math.isnan(got) and math.isnan(want)) or abs(
            got - want) <= VIEWER_FLOAT_BAR + 1e-12, (path, got, want)
    else:
        assert got == want, (path, got, want)


def viewer_chords_equal(got: list, want: list) -> None:
    """The HEB replies' chord rows: the same rows in the same order,
    values within the bar, but rows whose magnitudes tie within the bar
    may trade places (and at the cut stand in for each other), as phase
    27 holds the charts."""
    bar = VIEWER_FLOAT_BAR + 1e-12
    assert len(got) == len(want), (got, want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g["index"] == w["index"] == k
        assert abs(abs(g["value"]) - abs(w["value"])) <= bar, (g, w)
    pairs = {(w["a"], w["b"]): w["value"] for w in want}
    for g in got:
        v = pairs.get((g["a"], g["b"]))
        if v is None:  # a tie at the cut
            assert abs(abs(g["value"]) - abs(want[-1]["value"])) <= bar, g
        else:
            assert abs(g["value"] - v) <= bar, (g, v)


def viewer_svgs_alike(got: str, want: str, query: str) -> None:
    """HEB and t-SNE charts by their elements (phase 27 holds their values;
    a tie may swap two chords, t-SNE moves with any rounding); the others
    equal but for numbers within VIEWER_SVG_ATOL."""
    num = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
    if "kind=heb" in query or "kind=distribution" in query:
        for tag in ("<path", "<circle", "<title>"):
            assert got.count(tag) == want.count(tag), (query, tag)
        return
    assert num.split(got) == num.split(want), query
    a = np.array([float(v) for v in num.findall(got)])
    b = np.array([float(v) for v in num.findall(want)])
    assert float(np.abs(a - b).max(initial=0.0)) <= VIEWER_SVG_ATOL, query


def viewer_legend(app):
    """``(labels, panel rows and columns, domain)`` of the legend the
    viewer ``app`` draws over its frame (its ``_draw_overlays``), or None."""
    from correrender_tpu_torch.render.legend import _layout, _panel_bounds

    scene = app.scene
    r = next((r for r in scene.renderers if r["view"] == app.view and r[
        "type"] in ("dvr", "slice", "iso_ray", "iso_raster")), None)
    if not app.show_legend or r is None:
        return None
    field = r.get("field", scene.volume_data.field_names[0])
    domain = scene.transfer_functions[field].domain
    w, h = app.image_size
    x0, y0, bar_h, labels, total_w = _layout(h, w, domain, "right", 12, 8)
    return ([t for t, _ in labels], _panel_bounds(h, w, x0, y0, bar_h,
                                                  total_w), domain)


def viewer_session(card: str, label: str, clients, dirs, steps) -> dict:
    """Drive the card's and the CPU's servers with the same ``steps``:
    ``("api", cmd)``, ``("frame",)``, ``("get", path)``, ``("post", raw
    body, content type)``, ``("diagram", query)`` or ``("drill", cmd)``
    (``heb_drill`` into the first row of the last chord lists that names
    the same region pair on both sides); "{dir}" in a command is each
    server's own directory. Replies equal; frames within the frame bars,
    but an isosurface frame as phase 17 holds the iso scan (a ray may hit
    on one side only on at most 0.1% of the pixels), and where the two
    legends print other labels (a domain end near 0 printed from its
    rounding, e.g. |r|'s minimum) the legend panels are left out and the
    domains held within the float bar. Returns the counts."""
    from correrender_tpu_torch.utils.metrics import ssim

    def fill(obj, d):
        return json.loads(json.dumps(obj).replace("{dir}", d))

    def unfill(obj, d):
        return json.loads(json.dumps(obj).replace(d, "{dir}"))

    stats = {"frames": 0, "ops": 0, "err": 0.0, "ssim": 1.0,
             "card_s": 0.0, "cpu_s": 0.0}
    chords = ([], [])
    renderer, last, frames, slow, relabelled = "dvr", "start", [], [], []
    for step in steps:
        if step[0] == "drill":
            # The first row that names the same region pair on both
            # sides (tied rows may trade places).
            pick = next(k for k, (g, w) in enumerate(zip(*chords))
                        if (g["a"], g["b"]) == (w["a"], w["b"]))
            step = ("api", {**step[1], "chord": pick})
        outs, secs = [], []
        for client, d in zip(clients, dirs):
            t0 = time.perf_counter()
            if step[0] == "api":
                outs.append(unfill(client.api(fill(step[1], d)), d))
            elif step[0] == "frame":
                outs.append(client.image())
            elif step[0] == "post":
                outs.append(client.request("/api", step[1], step[2])[:3])
            else:
                path = step[1] if step[0] == "get" else "/diagram?" + step[1]
                outs.append(client.request(path)[:3])
            secs.append(time.perf_counter() - t0)
        stats["card_s"] += secs[0]
        stats["cpu_s"] += secs[1]
        what = (f"frame after {last}" if step[0] == "frame"
                else step[1].get("op") if step[0] == "api" else step[1])
        slow.append((secs[1], what))
        got, want = outs
        if step[0] == "api":
            viewer_replies_equal(got, want)
            assert got.get("ok") is not None, got
            if "chords" in want:
                chords = (got["chords"], want["chords"])
            if step[1]["op"] == "set_renderer" and got["ok"]:
                renderer = step[1]["renderer"]
            last = json.dumps(step[1])
            stats["ops"] += 1
        elif step[0] == "frame":
            assert got.shape == want.shape
            keep = np.ones(got.shape[:2], bool)
            legends = [viewer_legend(c.app) for c in clients]
            if None not in legends and legends[0][0] != legends[1][0]:
                for _, (by0, by1, bx0, bx1), _ in legends:
                    keep[by0:by1, bx0:bx1] = False
                for a, b in zip(legends[0][2], legends[1][2]):
                    assert abs(a - b) <= VIEWER_FLOAT_BAR, (what, legends)
                relabelled.append((legends[0][0], legends[1][0]))
            diff = np.abs(got - want)[keep]
            err, sim = float(diff.max()), ssim(got, want)
            off = float((diff > MAX_ABS_FRAME).any(axis=-1).mean())
            held = sim >= MIN_SSIM_FRAME and (
                err <= MAX_ABS_FRAME
                or (renderer in ("iso_ray", "iso_raster")
                    and off <= 1.0 - MIN_ISO_SCAN_FOUND_EQUAL))
            frames.append((what, renderer, err, off, sim, held))
            if renderer not in ("iso_ray", "iso_raster"):
                stats["err"] = max(stats["err"], err)
            stats["ssim"] = min(stats["ssim"], sim)
            stats["frames"] += 1
        else:
            assert got[:2] == want[:2], (step, got[:2], want[:2])
            if step[0] == "diagram" and got[0] == 200:
                viewer_svgs_alike(got[2].decode(), want[2].decode(), step[1])
            elif got[1] == "application/json" or step[0] == "post":
                viewer_replies_equal(json.loads(got[2]), json.loads(want[2]))
            else:
                assert got[2] == want[2], step
            stats["ops"] += 1
    iso = [f for f in frames if f[1] in ("iso_ray", "iso_raster")]
    print(f"[viewer {card}] {label}: {stats['ops']} requests and "
          f"{stats['frames']} frames, card and CPU servers: replies equal "
          f"(floats within {VIEWER_FLOAT_BAR}); frames but the isosurface's "
          f"max-abs {stats['err']:.3e} (bar {MAX_ABS_FRAME}), least SSIM "
          f"{stats['ssim']:.6f} (bar {MIN_SSIM_FRAME}); the isosurface "
          f"frames: " + "; ".join(
              f"{f[1]} max-abs {f[2]:.3e}, {100 * f[3]:.4f}% of the pixels "
              f"over {MAX_ABS_FRAME}" for f in iso)
          + f" (bar {100 * (1 - MIN_ISO_SCAN_FOUND_EQUAL):.1f}%); card "
          f"{stats['card_s']:.1f} s, CPU {stats['cpu_s']:.1f} s (slowest on "
          f"the CPU: " + ", ".join(f"{w} {t:.1f} s" for t, w in sorted(
              slow, key=lambda r: -r[0])[:4]) + f"); {len(relabelled)} "
          f"frames with other legend labels, their panels left out: "
          f"{relabelled}")
    bad = [f for f in frames if not f[5]]
    for f in bad:
        print(f"[viewer {card}] {label}: frame not held: {f}")
    assert not bad, bad
    return stats


def viewer_scenes(dev, data: np.ndarray, camera):
    """A Pearson ``dvr`` scene of the (E, Z, Y, X) ensemble on the card and
    one on the CPU, from the same arrays."""
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.calculators.correlation import (
        CorrelationCalculator)
    from correrender_tpu_torch.core.fields import GridMetadata, VolumeData

    es, zs, ys, xs = data.shape
    out = []
    for device in (dev, "cpu"):
        vd = VolumeData(GridMetadata(xs=xs, ys=ys, zs=zs, es=es),
                        device=device)
        vd.add_field("q", lambda t, e: data[e])
        vd.add_field("r", lambda t, e: data[(e + 1) % es])
        scene = Scene(vd, [camera])
        name = scene.add_calculator(CorrelationCalculator(
            "q", reference_point=(xs // 4, ys // 4, zs // 2)))
        scene.add_renderer("dvr", field=name)
        out.append(scene)
    return out


def viewer_steps(image_size, downsample: int, measures,
                 iso_raster_frame: bool = True) -> list:
    """The scripted session of tests/test_torch_port_viewer.py: every op
    of the viewer's command surface, its guards and the diagrams."""
    w, h = image_size
    frame = ("frame",)
    steps = [("get", "/"), ("get", "/api?op=info"),
             ("get", "/api?op=set_option&key=legend&value=false"),
             ("post", {"op": "set_option", "key": "legend", "value": False},
              "text/plain"),
             ("get", "/nothing"), frame,
             ("api", {"op": "orbit", "dtheta": 0.4, "dphi": 0.1}), frame,
             ("api", {"op": "zoom", "factor": 0.9}), frame,
             ("api", {"op": "pick_scroll", "amount": 0.3}),
             ("api", {"op": "pick", "px": w // 2, "py": h // 2}), frame,
             ("api", {"op": "pick_scroll", "amount": 0.3}), frame,
             ("api", {"op": "pick", "px": w, "py": h}),
             ("api", {"op": "pick", "px": w // 2 + 7, "py": h // 2 - 5})]
    for m in measures:
        steps += [("api", {"op": "set_measure", "measure": m}), frame]
    steps += [
        ("api", {"op": "set_measure", "measure": "pearson"}),
        ("api", {"op": "set_field", "field": "nope"}),
        ("api", {"op": "set_field", "field": "r"}), frame,
        ("api", {"op": "set_field", "field": "q"}),
        ("api", {"op": "set_colormap", "colormap": "viridis"}), frame,
        ("api", {"op": "set_colormap", "colormap": "nope"}),
        ("api", {"op": "set_tf", "opacity_points": [[0, 0.7], [0.5, 0.05],
                                                    [1, 0.7]]}), frame,
        ("api", {"op": "set_tf", "opacity_points": [[0.9, 0.1],
                                                    [0.1, 0.2]]}),
        ("api", {"op": "set_tf", "color_points": [
            [0.0, [0.1, 0.2, 0.9]], [0.5, [0.9, 0.9, 0.9]],
            [1.0, [0.9, 0.1, 0.1]]]}), frame,
        ("api", {"op": "set_tf", "color_points": [[0.5, [0, 0, 0]]]}),
        ("api", {"op": "tf_save", "path": "{dir}/tf.xml"}),
        ("api", {"op": "set_tf", "color_points": None,
                 "opacity_points": None}),
        ("api", {"op": "tf_load", "path": "{dir}/tf.xml"}), frame,
        ("api", {"op": "tf_load", "xml": "<NotATF/>"}),
        ("api", {"op": "set_absolute", "value": True}), frame,
        ("api", {"op": "set_absolute", "value": False}),
        ("api", {"op": "set_renderer", "renderer": "iso_ray"}),
        ("api", {"op": "set_renderer_option", "key": "iso_value",
                 "value": 0.5}), frame,
        ("api", {"op": "set_renderer", "renderer": "iso_raster"}),
        *([frame] if iso_raster_frame else []),
        ("api", {"op": "set_renderer", "renderer": "slice"}),
        ("api", {"op": "set_renderer_option", "key": "axis",
                 "value": "y"}),
        ("api", {"op": "set_renderer_option", "key": "position",
                 "value": 0.4}), frame,
        ("api", {"op": "set_renderer", "renderer": "nope"}),
        ("api", {"op": "set_renderer", "renderer": "dvr"}),
        ("api", {"op": "set_renderer_option", "key": "attenuation",
                 "value": 60.0}), frame,
        ("api", {"op": "set_view", "view": 0}),
        ("api", {"op": "set_view", "view": 3}),
        ("api", {"op": "set_time", "time": 5}),
        ("api", {"op": "set_member", "member": 2}),
        ("api", {"op": "set_option", "key": "legend", "value": False}),
        frame,
        ("api", {"op": "set_option", "key": "legend", "value": True}),
        ("api", {"op": "set_option", "key": "fast_dvr", "value": False}),
        frame,
        ("api", {"op": "set_option", "key": "fast_dvr", "value": True}),
        ("api", {"op": "checkpoint_save", "name": "home"}),
        ("api", {"op": "orbit", "dtheta": -0.7, "dphi": -0.2}), frame,
        ("api", {"op": "checkpoint_restore", "name": "home"}), frame,
        ("api", {"op": "checkpoint_restore", "name": "nope"}),
        ("api", {"op": "save_state", "path": "{dir}/state.json"}),
        ("api", {"op": "export_field", "path": "{dir}/field.nc"}),
        ("api", {"op": "similarity", "field_a": "q", "field_b": "r"}),
        ("api", {"op": "tf_optimize", "field_src": "q", "field_dst": "r",
                 "tf_size": 16}),
        ("api", {"op": "tf_optimize", "field_src": "q", "field_dst": "r",
                 "tf_size": 7}),
        ("api", {"op": "heb_chords", "downsample": downsample,
                 "num_samples": 6, "sampling_method": "mean"}),
        ("drill", {"op": "heb_drill", "downsample": downsample,
                   "num_samples": 6, "sampling_method": "mean"}), frame,
        ("diagram", f"kind=heb&downsample={downsample}&num_samples=6"
                    "&sampling_method=mean"),
        ("api", {"op": "heb_drill", "chord": 9999,
                 "downsample": downsample, "num_samples": 6,
                 "sampling_method": "mean"}),
        ("api", {"op": "heb_pop"}),
        ("api", {"op": "heb_reset"}), frame,
        ("api", {"op": "heb_pop"}),
        ("diagram", f"kind=heb&downsample={downsample}&num_samples=6"
                    "&sampling_method=mean&max_chords=30"),
        ("diagram", "kind=scatter&field_b=r"), ("diagram", "kind=matrix"),
        ("diagram", "kind=distribution&max_points=100"),
        ("diagram", "kind=timeseries"), ("diagram", "kind=nope"),
        ("api", {"op": "warp_core_breach"}), ("api", {"op": "timing"}),
        ("api", {"op": "info"}),
    ]
    return steps


def viewer_config1(dev, card: str) -> None:
    """29 (a): the scripted session on the card's and the CPU's servers, at
    config 1's grid and at the tests' grid."""
    import os
    import shutil

    from correrender_tpu_torch.app.baseline_configs import config1_camera
    from correrender_tpu_torch.utils.fixtures import synth_box_ensemble

    t0 = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    dirs = [os.path.abspath(os.path.join(VIEWER_DIR, d))
            for d in ("card", "cpu")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    # The CPU's iso_render frame at config 1's grid took 13.0 s (PR 16,
    # call 2); it is held at the tests' grid.
    runs = [("config 1's grid", CONFIG1_GRID, 100, VIEWER_CHECK_IMAGE, 16,
             ("pearson", "spearman"), False),
            ("the tests' grid", VIEWER_TESTS_GRID, VIEWER_TESTS_MEMBERS,
             VIEWER_TESTS_IMAGE, 4, VIEWER_MEASURES, True)]
    for label, (xs, ys, zs), members, image, downsample, measures, iso in runs:
        data = synth_box_ensemble(xs=xs, ys=ys, zs=zs, members=members)
        clients = [ViewerClient(sc, image) for sc in viewer_scenes(
            dev, data, config1_camera())]
        try:
            viewer_session(
                card, f"(a) {label} {xs}x{ys}x{zs} x {members}, {image[0]}x"
                f"{image[1]}, measures {', '.join(measures)}", clients, dirs,
                viewer_steps(image, downsample, measures, iso))
        finally:
            for c in clients:
                c.close()
    shutil.rmtree(VIEWER_DIR)
    torch.set_num_threads(threads)
    print(f"[viewer {card}] (a) {time.perf_counter() - t0:.1f} s (the CPU "
          f"server on {os.cpu_count()} threads)")


def viewer_launches(expect: dict, label: str) -> dict:
    """The launches since the last reset; fails unless they are ``expect``
    exactly (every other kernel 0)."""
    from correrender_tpu_torch.ops.cuda import _build

    got = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert got == expect, (label, got, expect)
    return got


def phase_viewer(dev, card: str, vd, name: str) -> None:
    """29. The viewer on the card (see the module docstring)."""
    from correrender_tpu_torch.app.baseline_configs import config1_camera
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.ops.cuda import _build
    from correrender_tpu_torch.render.pipeline import render_correlation_fast

    t_phase = time.perf_counter()
    viewer_config1(dev, card)
    side, members = vd.grid.xs, vd.grid.es
    calc = vd.calculators[name]
    scene = Scene(vd, [config1_camera()])
    scene.add_renderer("dvr", field=name)
    w, h = HEADLINE_IMAGE
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    client = ViewerClient(scene, HEADLINE_IMAGE)
    try:
        t0 = time.perf_counter()
        client.frame()
        first_s = time.perf_counter() - t0
        # The point moves: POST pick, then GET /frame.
        pixels = [(w // 2 + i * w // 80, h // 2 - i * h // 90)
                  for i in range(VIEWER_MOVES + 1)]
        rows = []
        for i, (px, py) in enumerate(pixels):
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            reply = client.api({"op": "pick", "px": px, "py": py})
            png, header_ms = client.frame()
            trip = (time.perf_counter() - t0) * 1e3
            assert reply["ok"], reply
            viewer_launches({"pearson": 1, "classify_to_cf": 1,
                             "shearwarp_composite": 1}, "point move")
            timing = client.api({"op": "timing"})
            if i:  # the first move is a warm-up
                rows.append((trip, timing, len(png), header_ms))
        img = decode_png(png)
        assert img.shape == (h, w, 4) and float(img[..., 3].max()) > 0.5
        trips = [r[0] for r in rows]
        split = {k: statistics.median(r[1][k] for r in rows)
                 for k in VIEWER_TIMING}
        print(f"[viewer {card}] (b) {side}^3 x {members} at {w}x{h}: the "
              f"first frame {first_s:.3f} s; point move (POST pick, GET "
              f"/frame) over loopback, {VIEWER_MOVES} after a warm-up: round "
              f"trip median {statistics.median(trips):.1f} ms (min "
              f"{min(trips):.1f}, max {max(trips):.1f}); the server's split, "
              f"medians: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                       split.items())
              + f"; PNG {statistics.median(r[2] for r in rows) / 1e6:.2f} "
              f"MB; launches a move K1 1, K2 1, K3 1 (exactly, every move)")
        # A cached frame: no launch, no server time.
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        cached, header_ms = client.frame()
        cached_ms = (time.perf_counter() - t0) * 1e3
        viewer_launches({}, "cached frame")
        assert cached == png and header_ms == 0.0, header_ms
        assert all(v == 0.0 for k, v in client.api({"op": "timing"}).items()
                   if k in VIEWER_TIMING)
        # The device part alone, and the Scene's frame of the same move
        # (phase 17 (a)), on the same scene.
        stack = vd.get_member_stack(calc.field_name)
        tf = scene.tf_for(name)
        cam = scene.views[0]
        fused_ms = median_ms(lambda: render_correlation_fast(
            stack, calc.reference_point, cam, tf, calc.measure,
            image_size=HEADLINE_IMAGE, background=(0.0, 0.0, 0.0, 0.0),
            intermediate_scale=1.0))
        points = [calc.reference_point, tuple(
            c + 3 * (i == 0) for i, c in enumerate(calc.reference_point))]
        moves = iter(range(10**6))

        def scene_move():
            calc.set_reference_point(*points[next(moves) % 2])
            return scene.render_view(0, image_size=HEADLINE_IMAGE)

        scene_ms = median_ms(scene_move)
        print(f"[viewer {card}] (b) beside it (CUDA events, median of 5): "
              f"the viewer's device frame (render_correlation_fast at scale "
              f"1.0) {fused_ms:.3f} ms; the Scene's point-move frame (phase "
              f"17 (a)) {scene_ms:.3f} ms")
        # The measure switch: the TF's new domain computes the field once
        # (the calculator), the frame once more (the fused path).
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        assert client.api({"op": "set_measure", "measure": "spearman"})["ok"]
        switch_ms = (time.perf_counter() - t0) * 1e3
        switch = viewer_launches({"spearman": 1}, "set_measure")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        client.frame()
        spearman_ms = (time.perf_counter() - t0) * 1e3
        spearman = viewer_launches({"spearman": 1, "classify_to_cf": 1,
                                    "shearwarp_composite": 1},
                                   "spearman frame")
        spearman_split = client.api({"op": "timing"})
        # Exact quality: the Scene's exact DVR (B5) on the Pearson field
        # the TF rebuild computed.
        assert client.api({"op": "set_measure", "measure": "pearson"})["ok"]
        assert client.api({"op": "set_option", "key": "fast_dvr",
                           "value": False})["ok"]
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        client.frame()
        exact_ms = (time.perf_counter() - t0) * 1e3
        exact = viewer_launches({"raymarch_dvr": 1}, "exact frame")
        exact_split = client.api({"op": "timing"})
        assert client.api({"op": "set_option", "key": "fast_dvr",
                           "value": True})["ok"]
        # One TF fit: the correlation field's TF to the raw field's DVR.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reply = client.api({"op": "tf_optimize", "field_src": "q",
                            "field_dst": name, "method": "ols",
                            "tf_size": VIEWER_TFOPT_SIZE})
        tfopt_s = time.perf_counter() - t0
        assert reply["ok"], reply
        assert bool(torch.isfinite(scene.transfer_functions[name].lut).all())
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        fitted, _ = client.frame()
        fitted_ms = (time.perf_counter() - t0) * 1e3
        viewer_launches({"pearson": 1, "classify_to_cf": 1,
                         "shearwarp_composite": 1}, "fitted-TF frame")
        assert decode_png(fitted).shape == (h, w, 4)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        print(f"[viewer {card}] (b) cached frame {cached_ms:.1f} ms round "
              f"trip, launches none, X-Server-Frame-Ms {header_ms}; "
              f"set_measure spearman {switch_ms:.1f} ms (launches {switch}: "
              f"the TF's domain), its frame {spearman_ms:.1f} ms (launches "
              f"{spearman}; split " + ", ".join(
                  f"{k} {spearman_split[k]}" for k in VIEWER_TIMING)
              + f"); exact frame {exact_ms:.1f} ms (launches {exact}; split "
              + ", ".join(f"{k} {exact_split[k]}" for k in VIEWER_TIMING)
              + f"); tf_optimize OLS R = {VIEWER_TFOPT_SIZE} from 'q' to "
              f"{name!r} {tfopt_s:.3f} s, then its frame {fitted_ms:.1f} ms; "
              f"peak +{peak / 2**30:.3f} GiB over "
              f"{base / 2**30:.3f} GiB allocated (round trips on the host "
              f"clock, over loopback)")
    finally:
        client.close()
    print(f"[viewer {card}] the phase {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    from correrender_tpu_torch.utils.fixtures import synth_box_stack

    t_start = time.perf_counter()
    name, smi = phase_device()
    card = smi
    dev = torch.device("cuda", 0)
    phase_build()
    errs = {k: 0.0 for k in KERNELS}
    phase_kernels(dev, errs)
    phase_kernels_exact(dev, errs)
    phase_kernels_measures(dev, errs)
    phase_kernels_iso(dev, errs)
    phase_kernels_moments(dev, errs)
    phase_config1(dev)
    phase_timelag(dev, card, errs)
    gen = torch.Generator(device=dev).manual_seed(0)
    side = HEADLINE_SIDE
    stack = synth_box_stack(side, side, side, HEADLINE_MEMBERS, gen, dev)
    stats, frame = phase_headline(dev, card, errs, stack)
    phase_profile(f"profile fast {card}", frame, {
        "K1 pearson_tiled_kernel": "pearson_tiled_kernel",
        "K2 classify_cf_kernel": "classify_cf_kernel",
        "K3 composite_taps_kernel": "composite_taps_kernel",
        "K3 composite_kernel": "composite_kernel",
        "warp bmm (cuBLAS gemm)": "gemm"},
        ("K1 pearson_tiled_kernel", "K3 composite_taps_kernel",
         "K3 composite_kernel"))
    exact_stats, exact_frame = phase_exact(dev, card, errs, stack)
    stats.update(exact_stats)
    phase_profile(f"profile exact {card}", exact_frame, {
        "B5 raymarch_dvr_kernel": "raymarch_dvr_kernel",
        "K1 pearson_tiled_kernel": "pearson_tiled_kernel"},
        ("B5 raymarch_dvr_kernel", "K1 pearson_tiled_kernel"))
    stats.update(phase_restricted(dev, card, errs, stack))
    iso_stats, iso_frame = phase_iso_frame(dev, card, errs, stack)
    stats.update(iso_stats)
    phase_profile(f"profile iso {card}", iso_frame, {
        "B6 raymarch_iso_kernel": "raymarch_iso_kernel",
        "K1 pearson_tiled_kernel": "pearson_tiled_kernel"},
        ("B6 raymarch_iso_kernel",))
    del frame, exact_frame, iso_frame
    phase_measures_grid(dev, card, errs, stack, stats)
    vd, field_name = phase_scene(dev, card, stack)
    phase_views(dev, card, vd, field_name)
    phase_derived(dev, card, vd)
    phase_neural(dev, card, vd)
    phase_diagrams(dev, card, vd, field_name)
    phase_tfopt(dev, card, vd, field_name)
    phase_viewer(dev, card, vd, field_name)
    del vd, stack
    phase_config5(dev, card)
    phase_iso_sharded(dev, card)
    phase_stress(dev, card)
    phase_multihost(dev, card)
    phase_decoders(dev, card)
    phase_iso_fast_config1(dev, card)
    phase_eye_inside(dev, card)
    phase_configs23(dev, card, errs)
    phase_members(dev, card, errs, stats)
    phase_iso_render(dev, card)
    phase_streamed(dev, card, errs, stats)
    print(f"[done {card}] chip_smoke.py phases took "
          f"{time.perf_counter() - t_start:.1f} s")
    # No single PyTorch call computes any of these functions (a field of
    # one correlation measure against one series, a LUT classification
    # into a slice layout, a shear-warp composite, a plane-order march),
    # so library_ms is null, except for B1: its moments are three torch
    # calls (sum, sum of squares, ref @ chunk), timed together.
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": stats[k][0],
         "max_abs_err": errs[k], "ms": stats[k][1], "plain_ms": stats[k][2],
         "bound_ms": stats[k][3], "bound_by": stats[k][4],
         "library_ms": stats[k][5] if len(stats[k]) > 5 else None}
        for k in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
