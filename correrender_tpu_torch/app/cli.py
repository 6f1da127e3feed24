"""Headless command-line interface of the port.

Counterpart of ``correrender_tpu/app/cli.py`` (the reference's app shell
and flags, src/Main.cpp:100-138: --perf, --sampling, --replicability) as
subcommands, every one of the JAX package's. Each command that loads
data, builds a scene or computes on tensors takes ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions):

  python -m correrender_tpu_torch.app.cli render --dataset f.nc \\
      --measure pearson --ref 10,20,5 --output out.png
  python -m correrender_tpu_torch.app.cli export --dataset f.nc \\
      --measure kendall --ref 1,2,3 --output corr.nc
  python -m correrender_tpu_torch.app.cli heb --dataset f.nc --output c.svg
  python -m correrender_tpu_torch.app.cli state --load scene.json \\
      --output view.png
  python -m correrender_tpu_torch.app.cli sampling --output sampling.csv
  python -m correrender_tpu_torch.app.cli perf --dataset f.nc --output p.csv
  python -m correrender_tpu_torch.app.cli info --dataset f.nc --device cpu
  python -m correrender_tpu_torch.app.cli view --dataset f.nc \\
      --measure pearson --ref 10,20,5 --port 8777
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np


def _load(args):
    from correrender_tpu_torch.io import load_volume, load_catalog
    from correrender_tpu_torch.io.catalog import open_dataset

    if args.catalog:
        entries = load_catalog(args.catalog)
        match = [e for e in entries if e.name == args.dataset]
        if not match:
            names = [e.name for e in entries]
            raise SystemExit(
                f"dataset {args.dataset!r} not in catalog; available: {names}"
            )
        return open_dataset(match[0], device=args.device)
    return load_volume(args.dataset, device=args.device)


def _save_png(img, path):
    """A float frame (a tensor on any device, or an array) as a PNG."""
    from PIL import Image

    from correrender_tpu_torch.app.camera_path import frame_to_uint8

    Image.fromarray(frame_to_uint8(img)).save(path)


def _parse_ref(s):
    return tuple(int(v) for v in s.split(","))


def cmd_info(args):
    vd = _load(args)
    g = vd.grid
    print(f"grid: {g.xs} x {g.ys} x {g.zs}  time steps: {g.ts}  "
          f"members: {g.es}")
    print(f"fields: {vd.field_names}")
    for name in vd.field_names:
        try:
            lo, hi = vd.get_min_max(name)
            print(f"  {name}: [{lo:.6g}, {hi:.6g}]")
        except Exception as e:
            print(f"  {name}: <error: {e}>")


def _build_render_scene(args):
    """Scene for ``render``: camera + optional correlation
    calculator + one volume renderer (+ outline)."""
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.calculators.correlation import CorrelationCalculator
    from correrender_tpu_torch.render.camera import Camera

    vd = _load(args)
    scene = Scene(vd, views=[Camera(position=tuple(
        float(v) for v in args.camera.split(",")))])
    field = args.field or vd.field_names[0]
    if args.measure:
        calc = CorrelationCalculator(
            field_name=field, measure=args.measure,
            field_name_ref=args.field_ref,
            reference_point=_parse_ref(args.ref),
            num_bins=args.mi_bins, k=args.kmi_neighbors,
            kraskov_estimator=args.kraskov_estimator,
        )
        field = scene.add_calculator(calc)
    scene.add_renderer(args.renderer, field=field,
                       **({"iso_value": args.iso_value}
                          if args.renderer in ("iso_ray", "iso_raster")
                          else {}))
    if args.outline:
        scene.add_renderer("domain_outline")
    scene.current_time = getattr(args, "time", 0)
    scene.current_member = getattr(args, "member", 0)
    return scene


def cmd_render(args):
    scene = _build_render_scene(args)
    w, h = (int(v) for v in args.size.split("x"))
    img = scene.render_view(0, image_size=(w, h),
                            fast_dvr=not args.exact_dvr,
                            show_legend=args.legend)
    _save_png(img, args.output)
    print(f"wrote {args.output}")


def cmd_view(args):
    from correrender_tpu_torch.app.viewer import serve

    if getattr(args, "state", None):
        from correrender_tpu_torch.app.state import Scene

        scene = Scene.load_state(args.state, device=args.device,
                                 catalog=args.catalog)
        if not scene.renderers:
            scene.add_renderer(
                "dvr", field=scene.volume_data.field_names[-1])
    elif not args.dataset:
        raise SystemExit("view needs --dataset or --state")
    else:
        scene = _build_render_scene(args)
    w, h = (int(v) for v in args.size.split("x"))
    serve(scene, host=args.host, port=args.port, image_size=(w, h),
          fast_dvr=not args.exact_dvr)


def cmd_export(args):
    from correrender_tpu_torch.calculators.correlation import CorrelationCalculator
    from correrender_tpu_torch.io import writers

    vd = _load(args)
    field = args.field or vd.field_names[0]
    if args.measure:
        calc = CorrelationCalculator(
            field_name=field, measure=args.measure,
            field_name_ref=getattr(args, "field_ref", None),
            reference_point=_parse_ref(args.ref),
            num_bins=args.mi_bins, k=args.kmi_neighbors,
            kraskov_estimator=args.kraskov_estimator,
        )
        vd.add_calculator(calc)
        field = calc.output_name
    writers.save_field(vd, field, args.output, time=args.time,
                       member=args.member)
    print(f"wrote {args.output}")


def cmd_mesh(args):
    """Isosurface mesh export (the reference's IsoSurfaceRasterizer
    export hooks + Export/WriteMesh.cpp obj/stl writers)."""
    from correrender_tpu_torch.io.writers import (
        write_obj,
        write_stl,
        write_tet_mesh,
        voxels_to_tet_mesh,
    )
    from correrender_tpu_torch.render.mesh import (
        extract_isosurface,
        vertex_normals,
    )

    vd = _load(args)
    field = args.field or vd.field_names[0]
    vol = vd.get_field(field, args.time, args.member).cpu().numpy()
    ext = os.path.splitext(args.output)[1].lower()
    if ext == ".tet":
        verts, tets = voxels_to_tet_mesh(vol, args.iso_value)
        write_tet_mesh(args.output, verts, tets)
        print(f"wrote {args.output} ({len(verts)} verts, "
              f"{len(tets)} tets)")
        return
    gamma = args.gamma if args.technique == "snapmc" else 0.0
    verts, tris = extract_isosurface(vol, args.iso_value,
                                     snap_gamma=gamma)
    if ext == ".stl":
        write_stl(args.output, verts, tris)
    else:
        write_obj(args.output, verts, tris,
                  normals=vertex_normals(verts, tris)
                  if len(verts) else None)
    print(f"wrote {args.output} ({len(verts)} verts, "
          f"{len(tris)} triangles)")


def cmd_heb(args):
    from correrender_tpu_torch.diagrams.heb import HEBChart

    vd = _load(args)
    field = args.field or vd.field_names[0]
    stack = vd.get_member_stack(field)

    def _pair(text):
        return tuple(float(v) for v in text.split(",")) if text else None

    factor = args.downsample
    if args.downsample_xyz:
        factor = tuple(int(v) for v in args.downsample_xyz.split(","))
    chart = HEBChart(
        stack, downsample_factor=factor,
        measure=args.measure or "pearson",
        sampling_method=args.sampling_method,
        num_samples=args.num_samples, max_chords=args.max_chords,
        correlation_range=_pair(args.correlation_range),
        cell_distance_range=_pair(args.cell_distance_range),
        color_map=args.color_map,
        color_map_variance=args.color_map_variance,
        bayesian_screening=not getattr(args, "no_bayesian_screening",
                                       False),
    )
    chart.compute_correlations()
    if getattr(args, "diagram_type", "chords") == "matrix":
        chart.render_matrix_svg(args.output)
        print(f"wrote {args.output} (matrix, {chart.num_leaves} regions)")
    else:
        chart.render_svg(args.output)
        print(f"wrote {args.output} ({len(chart.chords)} chords)")


def cmd_similarity(args):
    from correrender_tpu_torch.ops.similarity import field_similarity

    vd = _load(args)
    field_a = args.field or vd.field_names[0]
    vd_b = vd
    if args.dataset_b:
        from correrender_tpu_torch.io import load_volume

        vd_b = load_volume(args.dataset_b, device=args.device)
    field_b = args.field_b or field_a

    def flat(v, name):
        if args.all_members:
            return v.get_member_stack(name, args.time)
        return v.get_field(name, args.time, args.member)

    value = field_similarity(
        flat(vd, field_a), flat(vd_b, field_b), measure=args.measure
    )
    print(f"{args.measure} similarity({field_a}, {field_b}) = {value:.6f}")


def cmd_diagram(args):
    if args.kind == "timeseries":
        # Time-series datasets are (samples, time) NetCDF files, not
        # volumes — the branch has its own loader, and routing them
        # through load_volume would reject the (valid) 2-D layout.
        from correrender_tpu_torch.diagrams.timeseries import (
            load_time_series,
            render_heatmap_svg,
            time_series_correlation,
        )

        import torch

        series = torch.as_tensor(
            load_time_series(args.dataset, variable=args.field),
            device=args.device)
        m = time_series_correlation(
            series, measure=args.measure,
            estimator=getattr(args, "estimator", "classical"),
        )
        render_heatmap_svg(m, path=args.output)
        print(f"wrote {args.output}")
        return
    vd = _load(args)
    field = args.field or vd.field_names[0]
    if args.kind == "scatter":
        from correrender_tpu_torch.diagrams.scatter import render_scatter_svg

        field_b = args.field_b or field
        a = vd.get_field(field, member=args.member).cpu().numpy()
        b = vd.get_field(field_b, member=args.member).cpu().numpy()
        svg = render_scatter_svg(a, b, labels=(field, field_b),
                                 path=args.output)
    elif args.kind == "matrix":
        from correrender_tpu_torch.diagrams.matrix import (
            field_correlation_matrix,
            render_matrix_svg,
        )

        names = (
            [field, args.field_b] if args.field_b else vd.field_names
        )
        m, names = field_correlation_matrix(vd, names,
                                            measure=args.measure)
        render_matrix_svg(m, labels=names, path=args.output)
    elif args.kind == "radar":
        from correrender_tpu_torch.diagrams.radar import RadarBarChart

        g = vd.grid
        if args.ref:
            x, y, z = (int(v) for v in args.ref.split(","))
        else:
            x, y, z = g.xs // 2, g.ys // 2, g.zs // 2
        names = vd.field_names
        chart = RadarBarChart(equal_area=not args.equal_steps)
        if g.ts > 1:
            # One ring band per timestep, colored by value
            # (RadarBarChart::setDataTimeDependent). The reference
            # expects values pre-normalized to [0, 1]
            # (RadarBarChart::transferFunction clamps), so normalize
            # each variable by its own range across the time series —
            # otherwise heterogeneous units (pressure ~1e5 vs
            # temperature ~300) collapse to the colormap extremes.
            cols = []
            for n in names:
                vals, lo, hi = [], math.inf, -math.inf
                for t in range(g.ts):
                    vol = vd.get_field(n, t, args.member).cpu().numpy()
                    vals.append(float(vol[z, y, x]))
                    lo = min(lo, float(np.nanmin(vol)))
                    hi = max(hi, float(np.nanmax(vol)))
                span = (hi - lo) if hi > lo else 1.0
                cols.append([(v - lo) / span for v in vals])
            values = np.asarray(cols, np.float32).T  # (T, V)
            chart.set_data_time_dependent(names, values)
        else:
            # Slice radius = the field's value at the picked voxel,
            # normalized by its own volume range so heterogeneous
            # units share the chart.
            vals = []
            for n in names:
                vol = vd.get_field(n, 0, args.member).cpu().numpy()
                v = float(vol[z, y, x])
                lo, hi = (float(np.nanmin(vol)), float(np.nanmax(vol)))
                vals.append((v - lo) / (hi - lo) if hi > lo else 0.0)
            chart.set_data_time_independent(names, vals)
        chart.render_svg(args.output)
    elif args.kind == "distribution":
        from correrender_tpu_torch.diagrams.distribution_similarity import (
            distribution_similarity,
        )
        from correrender_tpu_torch.diagrams.scatter import render_scatter_svg

        stack = vd.get_member_stack(field)
        emb, labels, _ = distribution_similarity(
            stack, mode=args.mode, max_points=args.max_points
        )
        render_scatter_svg(
            emb[:, 0], emb[:, 1],
            labels=("t-SNE 1", "t-SNE 2"), colors=labels,
            path=args.output,
        )
        n_clusters = len(set(labels.tolist()) - {-1})
        print(f"{n_clusters} clusters over {len(labels)} points")
    print(f"wrote {args.output}")


def cmd_state(args):
    from correrender_tpu_torch.app.state import Scene

    # load_state auto-detects reference-app state files (state_ref.py);
    # --catalog resolves their dataset-by-name references.
    scene = Scene.load_state(args.load, device=args.device,
                             catalog=getattr(args, "catalog", None))
    if getattr(args, "save", None):
        scene.save_state(args.save)
        print(f"wrote {args.save}")
    if getattr(args, "save_reference", None):
        scene.save_state(args.save_reference, reference_format=True)
        print(f"wrote {args.save_reference} (reference format)")
    volume_fields = [r.get("field") or scene.volume_data.field_names[0]
                     for r in scene.renderers
                     if r["type"] in ("dvr", "slice", "iso_ray",
                                      "iso_raster")]
    if getattr(args, "tf", None):
        # Standalone sgl TF .xml (reference TF-widget file): applied
        # to every rendered field over its own scalar domain.
        from correrender_tpu_torch.render.tf import tf_from_xml_string

        with open(args.tf) as f:
            xml = f.read()
        for field in dict.fromkeys(volume_fields):
            lo, hi = scene.volume_data.get_min_max(
                field, scene.current_time, scene.current_member)
            scene.transfer_functions[field] = tf_from_xml_string(
                xml, domain=(lo, hi))
        print(f"applied TF {args.tf}")
    if getattr(args, "tf_export", None):
        from correrender_tpu_torch.render.tf import tf_to_xml_string

        if not volume_fields:
            raise SystemExit("--tf-export: no rendered field with a TF")
        with open(args.tf_export, "w") as f:
            f.write(tf_to_xml_string(scene.tf_for(volume_fields[0])))
        print(f"wrote {args.tf_export}")
    if not args.output:
        if not (getattr(args, "save", None)
                or getattr(args, "save_reference", None)
                or getattr(args, "tf_export", None)):
            raise SystemExit(
                "state needs --output and/or --save/--save-reference"
                "/--tf-export")
        return          # pure format conversion: no rendering
    if args.size:
        w, h = (int(v) for v in args.size.split("x"))
    else:
        # No explicit size: honor the state's window size (reference
        # files persist it), else the old default.
        w, h = getattr(scene, "window_size", None) or (800, 600)
    if args.dock:
        # One canvas, all views arranged per the persisted dock
        # layout (ViewManager role).
        _save_png(scene.render_dock(image_size=(w, h)), args.output)
        print(f"wrote {args.output}")
        return
    for view in range(len(scene.views)):
        img = scene.render_view(view, image_size=(w, h))
        if len(scene.views) == 1:
            path = args.output
        else:
            # splitext, not str.replace: an output without '.png'
            # collapsed every view into ONE silently-overwritten file.
            root, ext = os.path.splitext(args.output)
            path = f"{root}_view{view}{ext or '.png'}"

        _save_png(img, path)
        print(f"wrote {path}")
    # Diagram-family renderer nodes (reference DiagramRenderer &
    # friends draw as view overlays) render to SVGs alongside.
    diagrams = [r for r in scene.renderers
                if r["type"] in scene.DIAGRAM_TYPES
                and not r.get("hidden")]
    for i, node in enumerate(diagrams):
        root, _ = os.path.splitext(args.output)
        path = f"{root}_{node['type']}{i if len(diagrams) > 1 else ''}.svg"
        try:
            svg = scene.render_diagram(node)
        except ValueError as exc:
            print(f"skipping {node['type']} renderer: {exc}")
            continue
        with open(path, "w") as f:
            f.write(svg)
        print(f"wrote {path}")


def cmd_sampling(args):
    if getattr(args, "screened", False):
        from correrender_tpu_torch.app.sampling_test import (
            _load_stack,
            run_screened_sampling_tests,
        )

        stack = (None if not getattr(args, "dataset", None)
                 else _load_stack(args.dataset,
                                  getattr(args, "field", None),
                                  args.device))
        rows = run_screened_sampling_tests(
            stack=stack, synthetic=stack is None,
            num_pairs=max(args.num_pairs, 16), block=args.block,
            csv_path=args.output, device=args.device,
        )
    else:
        from correrender_tpu_torch.app.sampling_test import (
            run_sampling_test_index,
        )

        rows = run_sampling_test_index(
            args.test_index,
            dataset=getattr(args, "dataset", None),
            field=getattr(args, "field", None),
            csv_path=args.output,
            num_pairs=args.num_pairs, block=args.block,
            device=args.device,
        )
    for row in rows:
        print(row)
    print(f"wrote {args.output}")


def cmd_perf(args):
    from correrender_tpu_torch.app.perf import default_perf_states, run_perf_sweep
    from correrender_tpu_torch.app.state import Scene

    vd = _load(args)
    scene = Scene(vd)
    fields = (
        [f.strip() for f in args.fields.split(",")]
        if getattr(args, "fields", None) else [None]
    )
    states = default_perf_states(full=args.full, fields=fields)
    if args.frames is not None:
        # Only an explicit --frames overrides per-state frame counts:
        # the field-cycle state computes max(2*len(fields), 8) so
        # every field cycles twice.
        for s in states:
            s.num_frames = args.frames
    rows = run_perf_sweep(scene, states, csv_path=args.output)
    for row in rows:
        print(row)


def cmd_flythrough(args):
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.app.camera_path import orbit_path, render_flythrough
    from correrender_tpu_torch.calculators.correlation import CorrelationCalculator
    from correrender_tpu_torch.render.camera import Camera

    vd = _load(args)
    scene = Scene(vd, views=[Camera()])
    field = args.field or vd.field_names[0]
    if args.measure:
        calc = CorrelationCalculator(
            field_name=field, measure=args.measure,
            reference_point=_parse_ref(args.ref),
        )
        field = scene.add_calculator(calc)
    scene.add_renderer("dvr", field=field)
    scene.add_renderer("domain_outline")
    w, h = (int(v) for v in args.size.split("x"))
    time_indices = (
        list(range(vd.grid.ts)) if args.animate_time and vd.grid.ts > 1
        else None
    )
    out_dir = args.output_dir
    tmp_ctx = None
    if out_dir is None:
        if args.video:
            # Video-only invocation: stage frames in a temp dir instead
            # of littering the CWD with a default frames directory.
            import tempfile

            tmp_ctx = tempfile.TemporaryDirectory()
            out_dir = tmp_ctx.name
        else:
            out_dir = "flythrough_out"
    files = render_flythrough(
        scene, orbit_path(args.frames), out_dir,
        image_size=(w, h), time_indices=time_indices,
        video_path=args.video, fps=args.fps,
    )
    if tmp_ctx is None:
        print(f"wrote {len(files)} frames to {out_dir}"
              + (f" + video {args.video}" if args.video else ""))
    else:
        print(f"wrote video {args.video} ({len(files)} frames)")
        tmp_ctx.cleanup()


def cmd_replicability(args):
    from correrender_tpu_torch.app.replicability import run_replicability

    files = run_replicability(args.output_dir, small=not args.full,
                              device=args.device)
    for f in files:
        print(f"wrote {f}")


def cmd_imgmetrics(args):
    """MSE/PSNR/SSIM/LPIPS between two image files — the reference's
    scripts/similarity.py:47-66 workflow (ground truth vs
    approximation screenshots)."""
    import json as _json

    from PIL import Image

    import numpy as _np

    from correrender_tpu_torch.utils.metrics import compare_images

    def load(p):
        arr = _np.asarray(Image.open(p).convert("RGB"), _np.float32)
        return arr / 255.0

    a, b = load(args.image_a), load(args.image_b)
    if a.shape != b.shape:
        raise SystemExit(
            f"image sizes differ: {a.shape} vs {b.shape}"
        )
    print(_json.dumps(
        {k: round(float(v), 6)
         for k, v in compare_images(a, b, device=args.device).items()}
    ))


def cmd_weights(args):
    """Weight tooling: convert PyTorch/TorchScript archives (torch-free
    reader) and LPIPS checkpoints into the framework's .npz formats."""
    if args.weights_command == "convert":
        from correrender_tpu_torch.io.torchscript import torch_weights_to_npz

        arrays = torch_weights_to_npz(args.input, args.output)
        print(f"wrote {args.output} ({len(arrays)} tensors)")
        for name, arr in sorted(arrays.items()):
            print(f"  {name}: {list(arr.shape)} {arr.dtype}")
    elif args.weights_command == "lpips":
        from correrender_tpu_torch.utils.lpips_alex import convert_lpips_weights

        convert_lpips_weights(args.alexnet, args.lpips, args.output)
        print(f"wrote {args.output} — set CORRERENDER_LPIPS_WEIGHTS="
              f"{args.output} (or copy to ~/.cache/correrender_tpu/"
              "lpips_alex.npz) to enable real LPIPS")


def build_parser():
    p = argparse.ArgumentParser(
        prog="correrender_tpu_torch",
        description="correlation-field volume engine (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def add_device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device of the data and the compute "
                             "(cuda, cuda:N or cpu)")

    def add_dataset_args(sp, required=True):
        sp.add_argument("--dataset", required=required,
                        help="volume file path or catalog entry name")
        sp.add_argument("--catalog", default=None,
                        help="datasets.json path (then --dataset is a name)")
        sp.add_argument("--field", default=None)
        add_device_arg(sp)

    sp = sub.add_parser("info", help="print dataset metadata")
    add_dataset_args(sp)
    sp.set_defaults(fn=cmd_info)

    def add_scene_args(sp, dataset_required=True):
        add_dataset_args(sp, required=dataset_required)
        sp.add_argument("--measure", default=None,
                        help="correlation measure id "
                             "(omit: render raw field)")
        sp.add_argument("--field-ref", default=None,
                        help="reference-point field for SEPARATE-fields "
                             "correlation (default: same field)")
        sp.add_argument("--ref", default="0,0,0",
                        help="reference voxel x,y,z")
        sp.add_argument("--renderer", default="dvr",
                        choices=["dvr", "iso_ray", "iso_raster", "slice"])
        sp.add_argument("--iso-value", type=float, default=0.5)
        sp.add_argument("--camera", default="0.0,0.3,0.8")
        sp.add_argument("--size", default="800x600")
        sp.add_argument("--outline", action="store_true")
        sp.add_argument("--exact-dvr", action="store_true",
                        help="use the ray-marcher instead of shear-warp")
        sp.add_argument("--mi-bins", type=int, default=80)
        sp.add_argument("--kmi-neighbors", type=int, default=3)
        sp.add_argument("--kraskov-estimator", type=int, default=1,
                        choices=[1, 2])
        sp.add_argument("--time", type=int, default=0,
                        help="time step index")
        sp.add_argument("--member", type=int, default=0,
                        help="ensemble member index")

    sp = sub.add_parser("render", help="render a (correlation) field")
    add_scene_args(sp)
    sp.add_argument("--legend", action="store_true",
                    help="rasterize the TF color legend into the view")
    sp.add_argument("--output", required=True)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser(
        "view",
        help="interactive browser viewer (the reference GUI analogue: "
             "drag = orbit, wheel = zoom, shift+click = pick reference "
             "point, property panel for measure/field/TF/time/member)")
    add_scene_args(sp, dataset_required=False)
    sp.add_argument("--state", default=None,
                    help="open a saved scene state instead of building "
                         "one (native or reference-app format; "
                         "--catalog resolves dataset-by-name entries)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8777)
    sp.set_defaults(fn=cmd_view)

    sp = sub.add_parser(
        "mesh",
        help="extract + export an isosurface mesh (.obj/.stl/.tet — "
             "IsoSurfaceRasterizer export / WriteMesh parity)")
    add_dataset_args(sp)
    sp.add_argument("--iso-value", type=float, default=0.5)
    sp.add_argument("--technique", default="mc",
                    choices=["mc", "snapmc"],
                    help="marching (tetrahedra) or SnapMC-style "
                         "vertex snapping")
    sp.add_argument("--gamma", type=float, default=0.3,
                    help="SnapMC snap threshold in [0, 0.5)")
    sp.add_argument("--time", type=int, default=0)
    sp.add_argument("--member", type=int, default=0)
    sp.add_argument("--output", required=True,
                    help=".obj, .stl, or .tet")
    sp.set_defaults(fn=cmd_mesh)

    sp = sub.add_parser("export", help="export a (derived) field")
    add_dataset_args(sp)
    sp.add_argument("--measure", default=None)
    sp.add_argument("--field-ref", default=None)
    sp.add_argument("--ref", default="0,0,0")
    sp.add_argument("--mi-bins", type=int, default=80)
    sp.add_argument("--kmi-neighbors", type=int, default=3)
    sp.add_argument("--kraskov-estimator", type=int, default=1,
                    choices=[1, 2])
    sp.add_argument("--time", type=int, default=0)
    sp.add_argument("--member", type=int, default=0)
    sp.add_argument("--output", required=True, help=".nc or .cvol")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("heb", help="HEB chord diagram SVG")
    add_dataset_args(sp)
    sp.add_argument("--measure", default="pearson")
    sp.add_argument("--downsample", type=int, default=8)
    # Static tuple, not imported from diagrams.sampling: building the
    # parser stays import-light (that import pulls torch and ops into
    # every `--help`). A test holds it to SAMPLING_METHODS.
    sp.add_argument("--sampling-method", default="mean",
                    choices=("mean", "random", "halton", "plastic",
                             "bayesian"))
    sp.add_argument("--no-bayesian-screening", action="store_true",
                    help="run GP-UCB on ALL pairs instead of the "
                         "quasirandom screening's top fraction "
                         "(slower; see docs/ROUND4.md)")
    sp.add_argument("--num-samples", type=int, default=64)
    sp.add_argument("--max-chords", type=int, default=100)
    sp.add_argument("--downsample-xyz", default=None, metavar="FX,FY,FZ",
                    help="per-axis downscaling factors (overrides "
                         "--downsample; reference "
                         "downscaling_factor_x/y/z)")
    sp.add_argument("--correlation-range", default=None, metavar="LO,HI",
                    help="keep chords with |corr| in [LO, HI]")
    sp.add_argument("--cell-distance-range", default=None,
                    metavar="LO,HI",
                    help="keep leaf pairs whose downsampled-cell "
                         "distance is in [LO, HI]")
    sp.add_argument("--diagram-type", default="chords",
                    choices=["chords", "matrix"],
                    help="chord diagram or region-pair matrix heat map "
                         "(DiagramRenderer diagram_type)")
    sp.add_argument("--color-map", default="coolwarm",
                    help="chord colormap name (any of the reference's "
                         "38 diagram colormaps, e.g. 'Cool to Warm')")
    sp.add_argument("--color-map-variance", default="viridis",
                    help="std-dev outer-ring colormap name")
    sp.add_argument("--output", required=True)
    sp.set_defaults(fn=cmd_heb)

    sp = sub.add_parser(
        "diagram",
        help="2D analysis views: scatter / correlation matrix / "
             "distribution-similarity (t-SNE+DBSCAN) / time-series "
             "heatmap / radar bar chart → SVG",
    )
    add_dataset_args(sp)
    sp.add_argument("--kind", required=True,
                    choices=["scatter", "matrix", "distribution",
                             "timeseries", "radar"])
    sp.add_argument("--ref", default=None, metavar="X,Y,Z",
                    help="radar: voxel whose per-field values the "
                         "slices show (default: volume center)")
    sp.add_argument("--equal-steps", action="store_true",
                    help="radar: equal radial band widths instead of "
                         "equal-area bands (RadarBarChart equalArea "
                         "off)")
    sp.add_argument("--field-b", default=None)
    sp.add_argument("--measure", default="pearson")
    sp.add_argument("--member", type=int, default=0)
    sp.add_argument("--estimator", default="classical",
                    choices=["classical", "mine"],
                    help="timeseries heatmap estimator (mine = neural)")
    sp.add_argument("--mode", default="cell_member_values",
                    help="distribution feature mode")
    sp.add_argument("--max-points", type=int, default=400)
    sp.add_argument("--output", required=True)
    sp.set_defaults(fn=cmd_diagram)

    sp = sub.add_parser(
        "similarity",
        help="whole-field similarity of two fields (the reference's "
             "'Compute Field Similarity' dialog)",
    )
    add_dataset_args(sp)
    sp.add_argument("--field-b", default=None,
                    help="second field (default: --field vs itself in "
                         "--dataset-b)")
    sp.add_argument("--dataset-b", default=None,
                    help="second dataset (default: same dataset)")
    sp.add_argument("--measure", default="pearson")
    sp.add_argument("--all-members", action="store_true",
                    help="flatten across every member, not just one")
    sp.add_argument("--time", type=int, default=0)
    sp.add_argument("--member", type=int, default=0)
    sp.set_defaults(fn=cmd_similarity)

    sp = sub.add_parser("state", help="render a saved scene state "
                        "(native or reference-app format, auto-detected)")
    sp.add_argument("--load", required=True)
    sp.add_argument("--size", default=None,
                    help="WxH (default: the state's window size, "
                         "else 800x600)")
    sp.add_argument("--output", default=None,
                    help="view PNG path; omit for a pure state "
                         "conversion with --save/--save-reference")
    sp.add_argument("--save", default=None, metavar="PATH",
                    help="re-save the scene in the native schema "
                         "(converts reference files without rendering)")
    sp.add_argument("--dock", action="store_true",
                    help="one canvas, views arranged per dock_layout")
    sp.add_argument("--catalog", default=None,
                    help="datasets.json path for reference state files "
                         "that name their dataset by catalog entry")
    sp.add_argument("--save-reference", default=None, metavar="PATH",
                    help="additionally re-save the scene as a "
                         "reference-app-loadable state file")
    sp.add_argument("--tf", default=None, metavar="TF_XML",
                    help="standalone sgl TF .xml applied to every "
                         "rendered field (reference TF-widget file)")
    sp.add_argument("--tf-export", default=None, metavar="TF_XML",
                    help="write the first rendered field's transfer "
                         "function as a standalone sgl TF .xml")
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_state)

    sp = sub.add_parser("sampling", help="sampling-method eval (CSV)")
    sp.add_argument("--test-index", type=int, default=0,
                    help="0 synth-error | 1 data-error | 2 data-max | "
                         "3 data-max-subsampled (SamplingTest.cpp:150)")
    sp.add_argument("--dataset", help="dataset for the data-driven tests")
    sp.add_argument("--field", help="scalar field name (default: first)")
    sp.add_argument("--num-pairs", type=int, default=4)
    sp.add_argument("--block", type=int, default=8)
    sp.add_argument("--screened", action="store_true",
                    help="population-level screened-bayesian eval "
                         "(HEB's screening pipeline vs full GP vs "
                         "plastic at equal wall budget)")
    sp.add_argument("--output", required=True)
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_sampling)

    sp = sub.add_parser("perf", help="performance state sweep (CSV)")
    add_dataset_args(sp)
    sp.add_argument("--frames", type=int, default=None,
                    help="frames per state (default: per-state)")
    sp.add_argument("--full", action="store_true",
                    help="full resolution x renderer matrix")
    sp.add_argument("--fields",
                    help="comma-separated fields to sweep (default: "
                         "the dataset default)")
    sp.add_argument("--output", required=True)
    sp.set_defaults(fn=cmd_perf)

    sp = sub.add_parser("flythrough",
                        help="orbit-camera animation (optionally "
                             "time-stepped — the time-lag DVR config)")
    add_dataset_args(sp)
    sp.add_argument("--measure", default=None)
    sp.add_argument("--ref", default="0,0,0")
    sp.add_argument("--frames", type=int, default=24)
    sp.add_argument("--size", default="640x480")
    sp.add_argument("--animate-time", action="store_true")
    sp.add_argument("--output-dir", default=None,
                    help="frame PNG directory (default: flythrough_out, or a temp dir when only --video is given)")
    sp.add_argument("--video", help="also encode an MJPEG .avi")
    sp.add_argument("--fps", type=int, default=30)
    sp.set_defaults(fn=cmd_flythrough)

    sp = sub.add_parser("replicability",
                        help="reproduce the TVCG-2024 scene artifacts")
    sp.add_argument("--output-dir", default="replicability_out")
    sp.add_argument("--full", action="store_true")
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_replicability)

    sp = sub.add_parser(
        "imgmetrics",
        help="MSE/PSNR/SSIM/LPIPS between two images "
             "(scripts/similarity.py role)",
    )
    sp.add_argument("image_a")
    sp.add_argument("image_b")
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_imgmetrics)

    sp = sub.add_parser("weights",
                        help="weight tooling (torch->npz, LPIPS)")
    wsub = sp.add_subparsers(dest="weights_command", required=True)
    wc = wsub.add_parser(
        "convert",
        help="PyTorch/TorchScript archive -> .npz (torch-free reader)",
    )
    wc.add_argument("input", help=".pt/.pth archive")
    wc.add_argument("output", help="output .npz path")
    wl = wsub.add_parser(
        "lpips",
        help="official alexnet+lpips .pth files -> combined npz",
    )
    wl.add_argument("--alexnet", required=True,
                    help="torchvision alexnet state-dict .pth")
    wl.add_argument("--lpips", required=True,
                    help="lpips linear-head .pth (alex.pth)")
    wl.add_argument("--output", required=True)
    sp.set_defaults(fn=cmd_weights)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # HTML logfile of every invocation + uncaught failure (the sgl
    # Logfile role, README.md:152-157). Best-effort: a read-only
    # config dir must not break the command itself.
    log = None
    try:
        from correrender_tpu_torch.utils.logfile import get_logfile

        log = get_logfile()
        log.write_info(
            "correrender_tpu_torch " + " ".join(argv or sys.argv[1:])
        )
    except Exception:  # noqa: BLE001
        pass
    try:
        args.fn(args)
    except Exception as exc:  # noqa: BLE001 - log, then re-raise
        if log is not None:
            try:
                log.write_error(f"{type(exc).__name__}: {exc}")
            except Exception:  # noqa: BLE001
                pass
        raise


if __name__ == "__main__":
    main()
