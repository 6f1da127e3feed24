"""How a configuration is served: the calls into the program.

A driver is chosen by the configuration's ``serve.entry``: the file
``drivers/<entry>.py`` and its class ``Driver``. Each does its set-up in
``__init__(config, mix, seed, device, low_precision=False)`` (the data
drawn on the device from the seed, the program built, the warm-up
interactions run) and then answers ``interact(action)`` with the
interaction's outputs (``"field"``, ``"frame"``) without waiting for the
device. Besides it has ``grid_xyz``, ``interact_spans(action, spans)``
(the same with the per-layer spans recorded), ``inputs()`` (the
member-major blocks as the seed draws them, for the references),
``release()``, where an interaction may leave the reference point as
it is, ``point`` (the point in effect), and where set-up computed a
first field that the program's state depends on, ``first_point`` and
``first_field``.
``low_precision`` serves the program's own narrower path: the control of
the check. The program is imported by the drivers and nowhere else in
the benchmark.
"""

from __future__ import annotations

import time

import torch


class _HostStamp:
    """A CUDA event's ``record``/``elapsed_time`` on the host clock, for a
    run on the CPU."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3

    def synchronize(self) -> None:
        """Nothing runs behind the host's back on the CPU."""


def stamps(device, count: int):
    """``count`` CUDA timing events on a CUDA device, else host stamps."""
    if torch.device(device).type == "cuda":
        return [torch.cuda.Event(enable_timing=True) for _ in range(count)]
    return [_HostStamp() for _ in range(count)]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make(config: dict, mix: dict, seed: int, device,
         low_precision: bool = False):
    from benchmark import spec
    module = spec.load_module("drivers", config["serve"]["entry"])
    return module.Driver(config, mix, seed, device, low_precision)
