"""``scene``: the members served one by one to a ``VolumeData``, a
``CorrelationCalculator`` with the mix's measure and a ``Scene`` with
one renderer of ``serve.renderer`` and its ``serve.renderer_settings``.
An interaction moves the calculator's reference point or the view's
camera and calls ``Scene.render_view``."""

from __future__ import annotations

import time

import torch

from benchmark import data as bench_data
from benchmark import traffic
from benchmark.drivers import stamps, sync


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device,
                 low_precision: bool = False):
        from correrender_tpu_torch.app.state import Scene
        from correrender_tpu_torch.calculators.correlation import (
            CorrelationCalculator)
        from correrender_tpu_torch.core.fields import (
            GridMetadata, VolumeData)
        from correrender_tpu_torch.render.camera import Camera
        from correrender_tpu_torch.render.tf import TransferFunction

        self._camera_cls = Camera
        ds, serve = config["dataset"], config["serve"]
        if float(serve.get("intermediate_scale", 1.0)) != 1.0:
            raise ValueError("the Scene renders its shear-warp frames at "
                             "intermediate scale 1.0")
        self.device = torch.device(device)
        self.grid_xyz = (ds["xs"], ds["ys"], ds["zs"])
        self.image_size = tuple(serve["image_size"])
        (self.data,) = bench_data.planted_box(ds, ds["members"], seed,
                                              device)
        grid = GridMetadata(xs=ds["xs"], ys=ds["ys"], zs=ds["zs"], ts=1,
                            es=ds["members"])
        # The control: the program's bfloat16 member stack.
        self.vd = VolumeData(grid, device=device, member_stack_dtype=(
            torch.bfloat16 if low_precision else torch.float32))
        self.vd.add_field("members", lambda t, e: self.data[e])
        self.calc = CorrelationCalculator(
            field_name="members", measure=mix["measure"],
            reference_point=traffic.seeded_point(self.grid_xyz, seed),
            k=int(mix.get("k", 3)),
            kraskov_estimator=int(mix.get("kraskov_estimator", 1)))
        self.scene = Scene(self.vd)
        self.field_name = self.scene.add_calculator(self.calc)
        self.scene.add_renderer(serve["renderer"], field=self.field_name,
                                **serve.get("renderer_settings", {}))
        self.camera = None
        if "camera" in mix:
            self._set_camera(traffic.camera(mix["camera"]))
        tf = mix.get("transfer_function", "scene_default")
        if tf != "scene_default":
            self.scene.transfer_functions[self.field_name] = (
                TransferFunction.from_colormap(
                    tf["colormap"], domain=tuple(tf["domain"]),
                    opacity_points=tuple(map(tuple, tf["opacity_points"])),
                    device=self.vd.device))
        warm = traffic.warmup(mix, self.grid_xyz, seed, int(mix["warmup"]))
        # The first frame fixes the Scene's default transfer function
        # from its field; the check works it out again from the inputs.
        self.first_field = self.interact(warm[0])["field"].clone()
        self.first_point = self.point
        for action in warm[1:]:
            self.interact(action)
        sync(self.device)

    @property
    def point(self) -> tuple:
        """The reference point in effect."""
        return tuple(self.calc.reference_point)

    def _set_camera(self, cam: dict) -> None:
        self.camera = cam
        self.scene.views[0] = self._camera_cls(
            position=cam["position"], look_at_point=cam["look_at"],
            up=cam["up"], fovy=cam["fovy"], z_near=cam["z_near"],
            z_far=cam["z_far"])

    def _move(self, action: dict) -> None:
        if "point" in action:
            self.calc.set_reference_point(*action["point"])
        else:
            self._set_camera(action["camera"])

    def _field(self) -> torch.Tensor:
        return self.vd.get_field(self.field_name)

    def interact(self, action: dict) -> dict:
        self._move(action)
        frame = self.scene.render_view(0, image_size=self.image_size)
        return {"frame": frame, "field": self._field()}

    def interact_spans(self, action: dict, spans: dict) -> dict:
        """:meth:`interact` in two calls, the field first, with the host's
        time in the calls and CUDA-event spans of each."""
        events = stamps(self.device, 3)
        h0 = time.perf_counter()
        events[0].record()
        self._move(action)
        field = self._field()
        events[1].record()
        frame = self.scene.render_view(0, image_size=self.image_size)
        host = time.perf_counter() - h0
        events[2].record()
        sync(self.device)
        spans.setdefault("scene_host_ms", []).append(host * 1e3)
        if "point" in action:
            spans.setdefault("field_ms", []).append(
                events[0].elapsed_time(events[1]))
        spans.setdefault("render_ms", []).append(
            events[1].elapsed_time(events[2]))
        return {"frame": frame, "field": field}

    def inputs(self):
        return iter([self.data])

    def release(self) -> None:
        del self.scene, self.vd, self.calc
