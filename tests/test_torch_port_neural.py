"""PyTorch port (``calculators/neural.py``) vs the JAX package's neural
correlation calculator: the training set and the NaN stencil, the field
on carried-over weights, the retrain rule, weight presets, the legacy
type ids, the reference app's state files, and a Scene frame of a
neural field.

Both packages serve the same seeded numpy ensemble on the CPU; the JAX
calculator's weights reach the port through
``interop.srn_params_from_jax``.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch

from correrender_tpu.app import state_ref as jax_state_ref
from correrender_tpu.calculators import base as jax_base
from correrender_tpu.calculators import neural as jax_neural
from correrender_tpu.core.fields import GridMetadata as JaxGrid
from correrender_tpu.core.fields import VolumeData as JaxVolumeData
from correrender_tpu.models.mine import CorrelationSRN as JaxSRN

from correrender_tpu_torch.app import state_ref
from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.calculators import neural
from correrender_tpu_torch.calculators.base import (
    calculator_from_settings,
    known_calculator_types,
)
from correrender_tpu_torch.calculators.neural import (
    NeuralCorrelationCalculator,
)
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.interop import srn_params_from_jax
from correrender_tpu_torch.models.mine import CorrelationSRN
from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp
from correrender_tpu_torch.render.tf import TransferFunction

from test_torch_port_models import flat, make_srn_archive

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*torch\\.jit\\.script.*:DeprecationWarning")

# The field on the same weights: the SRN forward's bar (float32
# products of another summation order). Pearson targets: the port's
# plain K1 against JAX's Pearson on the CPU, the Pearson bar
# (tests/test_pallas.py:26).
ATOL_FIELD = 2e-5
ATOL_TARGETS = 2e-5
NEURAL_IDS = ("correlation_torch", "correlation_tiny_cuda_nn",
              "correlation_quick_mlp", "correlation_vmlp")
A7_TYPES = ("velocity", "vector_magnitude", "vorticity", "helicity",
            "binary_operator", "noise_reduction", "ensemble_mean",
            "ensemble_spread", "set_predicate", "residual_color",
            "dkl_calculator")
MODELS = {
    "frequency": dict(hidden=16, latent=8, num_frequencies=3),
    "hash_grid": dict(hidden=16, latent=8, encoding="hash_grid",
                      hash_levels=4, hash_log2_size=9, hash_base_res=3),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def ensemble(seed=0, shape=(16, 2, 6, 7, 9)):
    """(E, T, Z, Y, X) float32 around a smooth shared signal, with NaN
    members at a few voxels and one voxel constant over the members (a
    NaN Pearson field there: finite series, no valid target)."""
    rng = np.random.default_rng(seed)
    es, ts, zs, ys, xs = shape
    z, y, x = np.meshgrid(*(np.linspace(-1, 1, n) for n in (zs, ys, xs)),
                          indexing="ij")
    base = np.sin(3 * x) * np.cos(2 * y) + z
    data = np.stack([[base * (1 + 0.3 * rng.normal()) + 0.4 * rng.normal(
        size=base.shape) for _ in range(ts)] for _ in range(es)]).astype(
            np.float32)
    data[3, :, 1, 2, 3] = np.nan
    data[7, :, 4, 5, 6] = np.nan
    data[:, :, 2, 3, 4] = 0.5
    return data


def volumes(fields: dict):
    first = next(iter(fields.values()))
    es, ts, zs, ys, xs = first.shape
    grid = dict(xs=xs, ys=ys, zs=zs, ts=ts, es=es)
    jvd = JaxVolumeData(JaxGrid(**grid))
    tvd = VolumeData(GridMetadata(**grid), device="cpu")
    for name, data in fields.items():
        for vd in (jvd, tvd):
            vd.add_field(name, lambda t, e, d=data: d[e, t])
    return jvd, tvd


@pytest.fixture(scope="module")
def data():
    return ensemble()


def carried_over(kind, seed=0, **kw):
    """The same neural calculator in both packages on JAX-drawn weights
    (no training: ``_fit_key`` is None, as for preset weights)."""
    jmodel = JaxSRN.create(**MODELS[kind])
    jparams = jmodel.init(jax.random.key(seed))
    if kind == "hash_grid":
        # Tables of a trained grid's size, not the init's ±1e-4, so the
        # field varies over the grid.
        jparams["encoding"]["tables"] = [
            t * 1e3 for t in jparams["encoding"]["tables"]]
    jcalc = jax_neural.NeuralCorrelationCalculator(
        field_name="q", model=jmodel, params=jparams, **kw)
    tcalc = NeuralCorrelationCalculator(
        field_name="q", model=CorrelationSRN.create(**MODELS[kind]),
        params=srn_params_from_jax(jax.tree.map(np.asarray, jparams)), **kw)
    return jcalc, tcalc


def assert_same_params(a, b):
    a, b = flat(a), flat(b)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# -- the training set and the stencil --------------------------------------

@pytest.mark.parametrize("seed,refs", [(0, 4), (3, 7)])
def test_training_set_and_stencil_equal_jax(data, monkeypatch, seed, refs):
    jvd, tvd = volumes({"q": data})
    jcalc = jax_neural.NeuralCorrelationCalculator(field_name="q")
    tcalc = NeuralCorrelationCalculator(field_name="q")
    jvd.add_calculator(jcalc)
    tvd.add_calculator(tcalc)
    captured = {}

    def capture(model, pos_ref, pos_query, targets, steps):
        captured.update(pos_ref=pos_ref, pos_query=pos_query,
                        targets=targets)
        return model.init(jax.random.key(0)), 0.0

    monkeypatch.setattr(jax_neural, "train_srn", capture)
    jcalc.fit(0, num_reference_points=refs, seed=seed)
    samples = tcalc.training_set(0, num_reference_points=refs, seed=seed)
    pos_ref, pos_query, targets = (t.numpy() for t in samples.materialise())
    assert len(samples) == captured["targets"].shape[0] > 0
    np.testing.assert_array_equal(pos_ref, np.asarray(captured["pos_ref"]))
    np.testing.assert_array_equal(pos_query,
                                  np.asarray(captured["pos_query"]))
    np.testing.assert_allclose(targets, np.asarray(captured["targets"]),
                               rtol=0, atol=ATOL_TARGETS)
    stack = jvd.get_member_stack("q", 0)
    want = np.asarray(jcalc._nan_stencil(stack, 0))
    got = tcalc._nan_stencil(tvd.get_member_stack("q", 0), 0).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1, 2, 3] and not got[4, 5, 6] and got[2, 3, 4]
    # The constant voxel is in the stencil, but no field is finite there.
    assert not (samples.voxels.numpy() == (2 * 7 + 3) * 9 + 4).any()
    # A batch drawn from the set is the concatenation's rows.
    idx = torch.tensor([0, len(samples) - 1, len(samples) // 2])
    for got_part, whole in zip(samples.take(idx), (pos_ref, pos_query,
                                                   targets)):
        np.testing.assert_array_equal(got_part.numpy(), whole[idx.numpy()])


def test_fit_trains_on_the_training_set(data, monkeypatch):
    _, tvd = volumes({"q": data})
    tcalc = NeuralCorrelationCalculator(
        field_name="q", model=CorrelationSRN.create(**MODELS["frequency"]),
        train_steps=5)
    tvd.add_calculator(tcalc)
    seen = {}
    fit_srn = neural.fit_srn

    def spy(model, n, take, **kw):
        seen.update(n=n, **kw)
        return fit_srn(model, n, take, **kw)

    monkeypatch.setattr(neural, "fit_srn", spy)
    loss = tcalc.fit(0, num_reference_points=2)
    assert np.isfinite(loss) and tcalc._fit_key == ("q", 0)
    assert seen["n"] == len(tcalc.training_set(0, 2))
    assert seen["steps"] == 5 and seen["device"] == torch.device("cpu")


# -- the field on carried-over weights ------------------------------------

@pytest.mark.parametrize("kind", sorted(MODELS))
def test_compute_on_carried_over_weights_matches_jax(data, kind,
                                                     monkeypatch):
    jvd, tvd = volumes({"q": data})
    jcalc, tcalc = carried_over(kind, reference_point=(2, 3, 1))
    jvd.add_calculator(jcalc)
    tvd.add_calculator(tcalc)
    # A slab budget of two planes and a remainder (6 planes of 7 x 9).
    per_voxel = 8 * (tcalc.model.encoding.num_features + 4 * 16 + 4 * 8)
    monkeypatch.setattr(neural, "FIELD_BUDGET_BYTES", per_voxel * 63 * 4)
    fields = []
    for point in ((2, 3, 1), (8, 0, 5)):
        jcalc.set_reference_point(*point)
        tcalc.set_reference_point(*point)
        want = np.asarray(jvd.get_field(jcalc.output_name))
        got = tvd.get_field(tcalc.output_name).numpy()
        assert got.shape == want.shape == (6, 7, 9)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).sum() == 2
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FIELD)
        fields.append(got)
    # The move changed the field by far more than the bar.
    assert np.nanmax(np.abs(fields[0] - fields[1])) > 100 * ATOL_FIELD


def test_grid_positions_match_jax(data):
    jvd, tvd = volumes({"q": data})
    jcalc, tcalc = carried_over("frequency")
    jvd.add_calculator(jcalc)
    tvd.add_calculator(tcalc)
    np.testing.assert_array_equal(tcalc._grid_positions().numpy(),
                                  np.asarray(jcalc._grid_positions()))
    np.testing.assert_array_equal(tcalc._grid_positions(2, 5).numpy(),
                                  np.asarray(jcalc._grid_positions())[2:5])


# -- the retrain rule -------------------------------------------------------

def test_retrain_rule_on_a_field_or_time_switch(data, monkeypatch):
    _, tvd = volumes({"q": data, "r": ensemble(5)})
    calc = NeuralCorrelationCalculator(
        field_name="q", model=CorrelationSRN.create(**MODELS["frequency"]),
        train_steps=3)
    tvd.add_calculator(calc)
    fits = []
    fit = NeuralCorrelationCalculator.fit

    def counted(self, time=0, *a, **kw):
        fits.append((self.field_name, time))
        return fit(self, time, *a, **kw)

    monkeypatch.setattr(NeuralCorrelationCalculator, "fit", counted)
    calc.compute(0, 0)
    calc.compute(0, 1)  # another member: the same fit
    assert fits == [("q", 0)]
    calc.compute(1, 0)  # a time scrub retrains
    calc.field_name = "r"  # a field switch retrains
    calc.compute(1, 0)
    assert fits == [("q", 0), ("q", 1), ("r", 1)]
    # Preset weights are the user's choice: kept across switches.
    calc.params = calc.params
    calc._fit_key = None
    calc.field_name = "q"
    calc.compute(0, 0)
    assert len(fits) == 3


# -- weights ----------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(MODELS))
def test_weight_presets_interchange_through_the_calculators(tmp_path, kind):
    jcalc, tcalc = carried_over(kind, seed=4)
    path = str(tmp_path / "jax.npz")
    jcalc.save_weights(path)
    loaded = NeuralCorrelationCalculator(field_name="q", weights_path=path)
    np.testing.assert_array_equal(loaded.model.config_array(),
                                  jcalc.model.config_array())
    assert_same_params(loaded.params, tcalc.params)
    path = str(tmp_path / "port.npz")
    tcalc.save_weights(path)
    back = jax_neural.NeuralCorrelationCalculator(field_name="q",
                                                  weights_path=path)
    assert_same_params(back.params, jcalc.params)
    with pytest.raises(ValueError, match="no trained parameters"):
        NeuralCorrelationCalculator(field_name="q").save_weights(path)


def test_a_torchscript_archive_loads_as_in_jax(tmp_path):
    _, path = make_srn_archive(tmp_path)
    jcalc = jax_neural.NeuralCorrelationCalculator(field_name="q",
                                                   weights_path=path)
    tcalc = NeuralCorrelationCalculator(field_name="q", weights_path=path)
    assert tcalc._fit_key is None
    np.testing.assert_array_equal(tcalc.model.config_array(),
                                  jcalc.model.config_array())
    assert_same_params(tcalc.params, jcalc.params)


# -- type ids, settings and state files ------------------------------------

@pytest.mark.parametrize("type_id", NEURAL_IDS)
def test_legacy_ids_build_the_neural_calculator(type_id):
    settings = {"scalar_field_name": "q", "correlation_measure_type":
                "spearman", "reference_point_x": 1, "reference_point_y": 2,
                "reference_point_z": 3, "train_steps": 7,
                "continuous_recompute": True}
    got = calculator_from_settings(type_id, dict(settings))
    want = jax_base.calculator_from_settings(type_id, dict(settings))
    assert type(got) is NeuralCorrelationCalculator
    assert got.type_id == want.type_id == "correlation_vmlp"
    assert got.get_settings() == want.get_settings()
    assert got.reference_point == (1, 2, 3) and got.continuous_recompute
    assert got.output_name == want.output_name
    with pytest.raises(KeyError, match="unknown calculator type"):
        calculator_from_settings("nope", {})


def test_known_calculator_types_match_jax():
    assert known_calculator_types() == jax_base.known_calculator_types()
    for type_id in A7_TYPES:
        assert type(calculator_from_settings(type_id, {})).type_id == type_id


def neural_doc(type_id, preset):
    corr = {"type": "correlation", "state": {
        "correlation_measure_type": "pearson", "scalar_field_idx": "0",
        "reference_point_x": "2", "reference_point_y": "3",
        "reference_point_z": "1"}}
    node = {"type": type_id, "state": {
        "correlation_measure_type": "kendall", "scalar_field_idx": "0",
        "reference_point_x": "4", "reference_point_y": "1",
        "reference_point_z": "2", "model_file_path": preset,
        "network_implementation": "Fused MLP", "use_data_nan_stencil": "1",
        "an_unknown_key": "7"}}
    return {"window_size": {"x": 320, "y": 240},
            "global_camera": {"fovy": 0.9272952079772949,
                              "lookat": {"x": 0.0, "y": 0.0, "z": 0.0},
                              "pitch": -0.35, "yaw": -1.2,
                              "position": {"x": 0.25, "y": 0.3, "z": 0.7}},
            "views": [{"name": "3D View 1##data_view_0",
                       "sync_with_global_camera": True}],
            "calculators": [corr, node],
            "renderers": [{"type": "dvr", "state": {
                "selected_field_idx": "2", "view_visibility": "1"}}],
            "volume_data": {"name": "ensemble", "current_time_step_idx": 0,
                            "current_ensemble_idx": 0,
                            "transfer_functions": []}}


@pytest.mark.parametrize("type_id", NEURAL_IDS)
def test_reference_state_converts_neural_nodes_like_jax(tmp_path, data,
                                                        type_id):
    jcalc, tcalc = carried_over("frequency", seed=2)
    preset = str(tmp_path / "preset.npz")
    jcalc.save_weights(preset)
    doc = neural_doc(type_id, preset)
    want, want_warnings = jax_state_ref.convert_reference_state(
        copy.deepcopy(doc), ["q"])
    got, got_warnings = state_ref.convert_reference_state(
        copy.deepcopy(doc), ["q"])
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got_warnings == want_warnings
    node = got["calculators"][1]
    assert node["model_preset_path"] == preset
    assert node["_ref_extra"]["network_implementation"] == "Fused MLP"
    # Scene.load_state builds it with the preset's weights, and the
    # export writes the preset back under the reference's key.
    path = tmp_path / "ref.json"
    path.write_text(json.dumps(doc))
    _, tvd = volumes({"q": data})
    scene = Scene.load_state(str(path), volume_data=tvd)
    calc = next(c for c in tvd.calculators.values()
                if isinstance(c, NeuralCorrelationCalculator))
    assert calc.reference_point == (4, 1, 2) and calc.measure == "kendall"
    assert_same_params(calc.params, tcalc.params)
    out = state_ref.reference_state_from_scene(scene)
    state = next(c for c in out["calculators"]
                 if c["type"] == "correlation_vmlp")["state"]
    assert state["model_file_path"] == preset


def test_scene_frame_of_a_neural_field_equals_the_direct_call(data):
    _, tvd = volumes({"q": data})
    _, calc = carried_over("hash_grid", reference_point=(3, 2, 1))
    scene = Scene(tvd)
    name = scene.add_calculator(calc)
    field = tvd.get_field(name)
    lo, hi = float(np.nanmin(field)), float(np.nanmax(field))
    scene.transfer_functions[name] = TransferFunction.from_control_points(
        [(0.0, (0.1, 0.2, 0.9)), (1.0, (0.9, 0.2, 0.1))],
        [(0.0, 0.0), (1.0, 0.8)], domain=(lo, hi))
    scene.renderers = [{"type": "dvr", "view": 0, "field": name}]
    image = (96, 64)
    for point in ((3, 2, 1), (7, 5, 4)):
        calc.set_reference_point(*point)
        got = scene.render_view(0, image_size=image)
        field = tvd.get_field(name)
        want = dvr_shearwarp(field, scene.views[0], scene.tf_for(name),
                             image_size=image, box=tvd.grid.render_box(),
                             background=(0, 0, 0, 0))
        assert torch.equal(got, want)
        assert float(got[..., 3].max()) > 0
