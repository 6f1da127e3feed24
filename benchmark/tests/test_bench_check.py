"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size (the look for a chip skipped): a sound run passes,
and the control and each fault a cell can have fail it."""

import pytest
import torch

from bench_helpers import CELLS, CPU, SEED, tiny_cell
from benchmark import check
from benchmark.run import run_cell
from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.calculators import correlation

SCENE_CELLS = CELLS[1:]


def _run(name, **kwargs):
    result = run_cell(tiny_cell(name), SEED, 0.3, False, CPU, **kwargs)
    return result["correct"], result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    correct, report = _run(name)
    assert correct, report


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The program on its own bfloat16 path (chunks or member stack)."""
    correct, report = _run(name, driver_kwargs={"low_precision": True})
    assert not correct, report
    assert report["field_gap"]["value"] > report["field_gap"]["limit"]


@pytest.mark.parametrize("name", SCENE_CELLS)
def test_frame_control_fails(name, monkeypatch):
    """The reference frame with a float8 layout against the reference."""
    cell = tiny_cell(name)
    captured = {}
    real = check.readings

    def spy(cell_, driver, kept, seed, **kw):
        captured.update(driver=driver, kept=kept)
        return real(cell_, driver, kept, seed, **kw)

    monkeypatch.setattr(check, "readings", spy)
    run_cell(cell, SEED, 0.3, False, CPU)
    values = real(cell, captured["driver"], captured["kept"], SEED,
                  frame_layout=torch.float8_e4m3fn)
    assert values["frame_gap"] > cell.settings["limits"]["frame_gap"]


def _stale_field(monkeypatch):
    """A step that returns its state unchanged: the field of the first
    reference point, whatever the point."""
    first = {}
    real = correlation.correlate_field
    real_streamed = correlation.pearson_streamed

    def stale(*args, **kwargs):
        if "field" not in first:
            first["field"] = real(*args, **kwargs)
        return first["field"]

    def stale_streamed(chunks, ref):
        if "field" not in first:
            first["field"] = real_streamed(chunks, ref)
        return first["field"]

    monkeypatch.setattr(correlation, "correlate_field", stale)
    monkeypatch.setattr(correlation, "pearson_streamed", stale_streamed)


def _stale_frame(monkeypatch):
    first = {}
    real = Scene.render_view

    def stale(self, *args, **kwargs):
        if "frame" not in first:
            first["frame"] = real(self, *args, **kwargs)
        return first["frame"]

    monkeypatch.setattr(Scene, "render_view", stale)


def _half_members(monkeypatch):
    """Half of the members left out, the moments taken over the rest."""
    real = correlation.correlate_field
    real_streamed = correlation.pearson_streamed

    def half(stack, ref, *args, **kwargs):
        n = stack.shape[-1] // 2
        return real(stack[..., :n].contiguous(), ref[:n].contiguous(),
                    *args, **kwargs)

    def half_streamed(chunks, ref):
        keep = len(chunks) // 2
        n = sum(c.shape[0] for c in chunks[:keep])
        return real_streamed(chunks[:keep], ref[:n].contiguous())

    monkeypatch.setattr(correlation, "correlate_field", half)
    monkeypatch.setattr(correlation, "pearson_streamed", half_streamed)


def _altered_field(monkeypatch):
    """An answer altered where it is produced: one z-plane of the field."""
    real = correlation.correlate_field
    real_streamed = correlation.pearson_streamed

    def alter(field):
        field = field.clone()
        field[-1] += 0.25
        return field

    monkeypatch.setattr(correlation, "correlate_field",
                        lambda *a, **k: alter(real(*a, **k)))
    monkeypatch.setattr(correlation, "pearson_streamed",
                        lambda *a, **k: alter(real_streamed(*a, **k)))


def _altered_frame(monkeypatch):
    """An answer altered where it is produced: a tile of the frame."""
    real = Scene.render_view

    def alter(self, *args, **kwargs):
        frame = real(self, *args, **kwargs).clone()
        frame[:16, :16] = 1.0
        return frame

    monkeypatch.setattr(Scene, "render_view", alter)


FAULTS = {"stale_field": _stale_field, "half_members": _half_members,
          "altered_field": _altered_field}
FRAME_FAULTS = {"stale_frame": _stale_frame,
                "altered_frame": _altered_frame}


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in sorted(FAULTS)
    # A camera flight's field is the set-up's: it has no later state.
    if not (fault == "stale_field" and "orbit" in name)])
def test_field_fault_fails(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    correct, report = _run(name)
    assert not correct, report


@pytest.mark.parametrize("fault", sorted(FRAME_FAULTS))
@pytest.mark.parametrize("name", SCENE_CELLS)
def test_frame_fault_fails(name, fault, monkeypatch):
    FRAME_FAULTS[fault](monkeypatch)
    correct, report = _run(name)
    assert not correct, report
