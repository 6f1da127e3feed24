"""HEB diagram drill-down stack (focus + context).

Counterpart of ``correrender_tpu/diagrams/drilldown.py``; the stack is a
tensor and stays on its device (a focus chart takes a view of it).
Reference: src/Renderers/Diagram/DiagramRenderer.{hpp,cpp}:62-100 — the
diagram renderer keeps a *stack* of HEB charts: selecting a chord
(region pair) in the context chart spawns a focus chart over just those
two regions at finer granularity; selections propagate outlines back to
the 3D views. Headless analogue: :class:`HEBDrilldown` manages the
stack, produces per-level SVGs and exposes the selected regions for
view outlining.
"""

from __future__ import annotations

from correrender_tpu_torch.diagrams.heb import HEBChart
from correrender_tpu_torch.diagrams.octree import GridRegion
from correrender_tpu_torch.diagrams.sampling import as_stack


def _crop(stack, region: GridRegion):
    return stack[
        region.z_min : region.z_max + 1,
        region.y_min : region.y_max + 1,
        region.x_min : region.x_max + 1,
    ]


class HEBDrilldown:
    """A stack of HEB charts: level 0 = whole-volume context chart;
    each deeper level focuses on one selected chord's region pair."""

    def __init__(
        self,
        stack,
        downsample_factor: int = 8,
        measure: str = "pearson",
        max_chords: int = 100,
        focus_sampling_method: str | None = None,
        focus_num_samples: int | None = None,
        **chart_kwargs,
    ):
        """``focus_sampling_method`` / ``focus_num_samples`` override
        the context chart's sampling settings for the drilled (focus)
        levels — the reference's separate focus-diagram settings
        (``sampling_method_type_focus`` / ``num_samples_focus``,
        DiagramRenderer.cpp settings map). Focus domains are small, so
        the reference typically samples them denser than the context
        sweep over all pairs."""
        self.stack = as_stack(stack)
        self.measure = measure
        self.max_chords = max_chords
        self.chart_kwargs = chart_kwargs
        self.focus_overrides = {}
        if focus_sampling_method is not None:
            self.focus_overrides["sampling_method"] = str(
                focus_sampling_method)
        if focus_num_samples is not None:
            self.focus_overrides["num_samples"] = int(focus_num_samples)
        root = HEBChart(
            self.stack, downsample_factor=downsample_factor,
            measure=measure, max_chords=max_chords, **chart_kwargs,
        )
        root.compute_correlations()
        #: (chart, region_pair or None, offset (z, y, x), drilled
        #: (leaf_i, leaf_j) in the PARENT chart or None) per level.
        #: One tuple per level keeps every per-level fact in a single
        #: list, so concurrent readers (the viewer serves frames and
        #: diagrams off-lock) get a consistent view from ONE
        #: ``self.levels`` read — there is no second list that a
        #: racing ``pop`` could leave out of step.
        self.levels = [(root, None, (0, 0, 0), None)]

    @property
    def depth(self) -> int:
        return len(self.levels)

    def current_chart(self) -> HEBChart:
        return self.levels[-1][0]

    def selected_regions(self):
        """Full-resolution regions selected at each drill level (for
        3D-view outlines, mirroring the reference's selection
        propagation)."""
        out = []
        for chart, pair, offset, _ in self.levels[1:]:
            out.extend(pair)
        return out

    @property
    def drilled_leaf_pairs(self) -> list:
        """Drilled chord's (leaf_i, leaf_j) per level past the root —
        feeds the context chart's selection highlight. Derived from
        ``levels`` so it can never fall out of step with it."""
        return [lvl[3] for lvl in self.levels[1:]]

    def drill_into_chord(self, chord_index: int = 0,
                         downsample_factor: int | None = None):
        """Focus on the regions of the given chord of the current chart.

        The focus chart re-analyzes the two regions' combined voxels at
        finer granularity (half the parent's downsampling by default).
        """
        chart, _, offset, _ = self.levels[-1]
        if not chart.chords:
            raise ValueError("current chart has no chords to drill into")
        i, j, _value = chart.chords[chord_index]
        region_a = _offset_region(chart._upscale(chart.leaves[i]), offset)
        region_b = _offset_region(chart._upscale(chart.leaves[j]), offset)

        # Bounding box of the pair (the focus domain).
        focus = GridRegion(
            min(region_a.x_min, region_b.x_min),
            min(region_a.y_min, region_b.y_min),
            min(region_a.z_min, region_b.z_min),
            max(region_a.x_max, region_b.x_max),
            max(region_a.y_max, region_b.y_max),
            max(region_a.z_max, region_b.z_max),
        )
        sub = _crop(self.stack, focus)
        if downsample_factor is None:
            # Halve PER AXIS: collapsing anisotropic factors like
            # (8, 8, 1) to scalar max//2 = 4 made the focus chart
            # COARSER than the context on the flat axis (round-3
            # review; anisotropic grids are the per-axis knob's whole
            # point).
            downsample_factor = tuple(
                max(f // 2, 1) for f in chart.factors
            )
        focus_chart = HEBChart(
            sub, downsample_factor=downsample_factor,
            measure=self.measure, max_chords=self.max_chords,
            **{**self.chart_kwargs, **self.focus_overrides},
        )
        focus_chart.offset = (focus.z_min, focus.y_min, focus.x_min)
        focus_chart.compute_correlations()
        self.levels.append(
            (
                focus_chart,
                (region_a, region_b),
                (focus.z_min, focus.y_min, focus.x_min),
                (i, j),
            )
        )
        return focus_chart

    def pop(self):
        """Return to the parent chart (the reference's back button)."""
        if len(self.levels) > 1:
            self.levels.pop()
        return self.current_chart()

    def render_context_svg(self, size: int = 800, **render_kw) -> str:
        """The PARENT chart with the drilled chord highlighted —
        the reference's context diagram above the focus diagram
        (selection propagation + desaturate-unselected,
        DiagramRenderer.hpp:62-100). At the root (depth 1) this is
        just the root chart."""
        # One snapshot: the viewer serves this off-lock, so a
        # concurrent pop between a depth check and the level reads
        # must not be able to hand us mismatched indices.
        levels = list(self.levels)
        if len(levels) < 2:
            return levels[0][0].render_svg(size=size, **render_kw)
        return levels[-2][0].render_svg(
            size=size, highlight=levels[-1][3], **render_kw)

    def render_svgs(self, path_prefix: str) -> list:
        """Write one SVG per stack level; returns the paths."""
        paths = []
        for lvl, (chart, *_) in enumerate(self.levels):
            p = f"{path_prefix}_level{lvl}.svg"
            chart.render_svg(p)
            paths.append(p)
        return paths


def _offset_region(region: GridRegion, offset) -> GridRegion:
    oz, oy, ox = offset
    return GridRegion(
        region.x_min + ox, region.y_min + oy, region.z_min + oz,
        region.x_max + ox, region.y_max + oy, region.z_max + oz,
    )
