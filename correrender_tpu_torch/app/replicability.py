"""Replicability mode: scripted reproduction of the TVCG-2024 setup.

Counterpart of ``correrender_tpu/app/replicability.py`` (the reference's
src/Replicability/ReplicabilityState.hpp and --replicability flag): the
``linear_4x4`` synthetic ensemble with the paper's analysis setup (a
Pearson calculator, DVR and outline views, an HEB diagram), rendered
headlessly: the view PNGs, the HEB SVG, the ensemble as NetCDF and the
scene as a native and a reference-app state file, which
``Scene.load_state`` opens again.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from correrender_tpu_torch.app.camera_path import frame_to_uint8
from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.calculators.correlation import (
    CorrelationCalculator)
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.utils import fixtures


def build_replicability_scene(xs: int = 128, ys: int = 128, zs: int = 32,
                              members: int = 100, seed: int = 0,
                              device="cuda"):
    """The linear_4x4 planted-box ensemble with the paper's analysis
    setup: Pearson correlation against a box-centre reference point, DVR
    and outline views. Returns ``(scene, data)``, ``data`` the
    ``(members, Z, Y, X)`` host array."""
    data = fixtures.synth_box_ensemble(xs=xs, ys=ys, zs=zs, members=members,
                                       linear=True, seed=seed)
    vd = VolumeData(GridMetadata(xs=xs, ys=ys, zs=zs, es=members),
                    device=device)
    vd.add_field("data", lambda t, e: data[e])
    scene = Scene(vd, views=[Camera(position=(0.0, 0.3, 0.8)),
                             Camera(position=(0.6, 0.4, 0.4))])
    g = zs // 2
    calc = CorrelationCalculator(field_name="data", measure="pearson",
                                 reference_point=(g, g, zs // 2))
    corr_name = scene.add_calculator(calc)
    scene.add_renderer("dvr", view=0, field=corr_name)
    scene.add_renderer("domain_outline", view=0)
    scene.add_renderer("dvr", view=1, field=corr_name)
    return scene, data


def run_replicability(output_dir: str, image_size=(800, 600),
                      small: bool = True, device="cuda"):
    """Render the replicability artifacts; returns the file list."""
    from PIL import Image

    from correrender_tpu_torch.diagrams.heb import HEBChart
    from correrender_tpu_torch.io import writers

    os.makedirs(output_dir, exist_ok=True)
    kwargs = dict(xs=64, ys=64, zs=16, members=50) if small else {}
    scene, data = build_replicability_scene(**kwargs, device=device)
    files = []
    for view in range(len(scene.views)):
        img = scene.render_view(view, image_size=image_size)
        path = os.path.join(output_dir, f"replicability_view{view}.png")
        Image.fromarray(frame_to_uint8(img)).save(path)
        files.append(path)

    # HEB chord diagram over the ensemble.
    stack = torch.as_tensor(np.ascontiguousarray(np.moveaxis(data, 0, -1)),
                            device=scene.volume_data.device)
    chart = HEBChart(stack, downsample_factor=max(stack.shape[0] // 4, 4),
                     max_chords=60)
    chart.compute_correlations()
    svg_path = os.path.join(output_dir, "replicability_heb.svg")
    chart.render_svg(svg_path)
    files.append(svg_path)

    # The ensemble as NetCDF, referenced from the state files so
    # `cli state --load` reloads it.
    nc_path = os.path.join(output_dir, "replicability_ensemble.nc")
    writers.write_netcdf(nc_path, data[:, None], name="data")
    files.append(nc_path)
    state_path = os.path.join(output_dir, "replicability_state.json")
    scene.save_state(state_path, dataset={"filename": nc_path,
                                          "name": "linear_4x4"})
    files.append(state_path)
    # The same scene in the reference app's own schema.
    ref_path = os.path.join(output_dir, "replicability_state_ref.json")
    scene.save_state(ref_path, dataset={"filename": nc_path},
                     reference_format=True)
    files.append(ref_path)
    return files
