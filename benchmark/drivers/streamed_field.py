"""``streamed_field``: the Pearson field of a member stack held as
resident member-major chunks of ``serve.chunk_members`` in
``serve.dtype``. An interaction gathers the reference point's series
from the chunks and calls ``calculators.correlation.pearson_streamed``
(B1 per chunk, then ``pearson_from_moments``)."""

from __future__ import annotations

import torch

from benchmark import data as bench_data
from benchmark import traffic
from benchmark.drivers import sync

#: The chunk types the program streams, and the next narrower of each
#: (the control's).
NARROWER = {torch.float32: torch.bfloat16}


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device,
                 low_precision: bool = False):
        from correrender_tpu_torch.calculators.correlation import (
            pearson_streamed)

        self._pearson_streamed = pearson_streamed
        ds, serve = config["dataset"], config["serve"]
        if mix.get("measure", "pearson") != "pearson":
            raise ValueError("pearson_streamed computes Pearson only")
        dtype = getattr(torch, serve["dtype"])
        if dtype not in NARROWER:
            raise ValueError(f"chunks in {serve['dtype']} are not served")
        self.grid_xyz = (ds["xs"], ds["ys"], ds["zs"])
        self._draw = lambda: bench_data.planted_box(
            ds, serve["chunk_members"], seed, device)
        # The control streams the next narrower chunks, drawn as the
        # served ones are; both are not held at once (62.5 GB and
        # 31 GB), so the check draws the served chunks again.
        self.low_precision = low_precision
        served = NARROWER[dtype] if low_precision else dtype
        self.chunks = [c.to(served) for c in self._draw()]
        self.dtype = dtype
        for action in traffic.warmup(mix, self.grid_xyz, seed,
                                     int(mix["warmup"])):
            self.interact(action)
        sync(device)

    def inputs(self):
        """The member blocks as served (the control's: as the
        configuration serves them)."""
        if self.low_precision:
            return (c.to(self.dtype) for c in self._draw())
        return iter(self.chunks)

    def interact(self, action: dict) -> dict:
        x, y, z = action["point"]
        ref = torch.cat([c[:, z, y, x] for c in self.chunks]).float()
        return {"field": self._pearson_streamed(self.chunks, ref)}

    def interact_spans(self, action: dict, spans: dict) -> dict:
        return self.interact(action)

    def release(self) -> None:
        if self.low_precision:
            del self.chunks
