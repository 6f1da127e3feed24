"""PyTorch port (``correrender_tpu_torch``) vs the JAX package: the
command line (``app/cli.py``) and its harnesses (``app/perf.py``,
``app/sampling_test.py``, ``app/replicability.py``).

Each ported subcommand runs with ``--device cpu`` on the NetCDF fixtures
of ``tests/test_app.py`` (12×12×6 × 15 members and 10×10×5 × 12), and its
output is held to the JAX CLI's on the same files: images within the
frame bars (max-abs ≤ 1e-2, SSIM ≥ 0.995), SVGs equal but for numbers
within 1e-5 relative (a chord's width carries its correlation), fields
within the measures' bars, meshes, state files and CSVs equal apart from
times. The t-SNE chart is held by its structure (ROADMAP C: it is
unstable at a few hundred points in both packages).

Also BASELINE's ``run_all`` (configs patched to small fakes, and on the
CPU, where configs 1-3 refuse to run) and the package exports of
``app``, ``render`` and ``io`` against the JAX ``__init__``s.

The sampling harness's ``error_quantile`` ranks the found maximum among
the exhaustive pair values. The box fixture holds many equal values, so
a found maximum one ulp from JAX's moves its rank by the size of the tie:
the rows are held within that tie's share of the pair count, the other
errors within 1e-6.
"""

import contextlib
import csv
import io
import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from correrender_tpu.app import cli as jax_cli
from correrender_tpu.app import perf as jax_perf
from correrender_tpu.app import replicability as jax_rep
from correrender_tpu.app import sampling_test as jax_st
from correrender_tpu.diagrams.octree import GridRegion as JaxRegion
from correrender_tpu.io import writers as jax_writers
from correrender_tpu.utils import fixtures as jfixtures

from correrender_tpu_torch.app import cli, perf, replicability, sampling_test
from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.diagrams.octree import GridRegion
from correrender_tpu_torch.io import load_volume
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.utils.metrics import ssim

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
MAX_ABS_FRAME = 1e-2
MIN_SSIM_FRAME = 0.995
SVG_RTOL = 1e-5
#: Field bars of the measures (tests/test_torch_port_measures.py).
FIELD_BARS = {"pearson": 2e-5, "spearman": 2e-6, "kendall": 1e-6}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the tier-1 command runs six xdist workers on
    eight cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def config_dir(tmp_path, monkeypatch):
    """Both CLIs log each invocation under the config directory."""
    path = tmp_path / "config"
    monkeypatch.setenv("CORRERENDER_CONFIG_DIR", str(path))
    return path


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_data")
    data = jfixtures.synth_box_ensemble(xs=12, ys=12, zs=6, members=15)
    jax_writers.write_netcdf(str(d / "d.nc"), data[:, None], name="temp")
    data2 = jfixtures.synth_box_ensemble(xs=10, ys=10, zs=5, members=12)
    jax_writers.write_netcdf(str(d / "d2.nc"), data2[:, None], name="temp")
    rng = np.random.default_rng(2)
    tt = np.linspace(0, 8 * np.pi, 120)
    series = (np.stack([np.sin(tt), np.sin(tt), np.cos(tt), np.sin(2 * tt)])
              + 0.05 * rng.normal(size=(4, 120))).astype(np.float32)
    jax_writers.write_netcdf(str(d / "ts.nc"), series[:, None],
                             name="series")
    return d


def run(mod, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main([str(a) for a in argv])
    return buf.getvalue()


def both(argv, out_dir, port_extra=("--device", "cpu")):
    """Run ``argv`` through both CLIs; ``{o}`` in an argument becomes
    ``out_dir/jax_*`` or ``out_dir/port_*``. Returns both stdouts with the
    prefixes made ``{o}`` again."""
    outs = []
    for mod, tag, extra in ((jax_cli, "jax_", ()),
                            (cli, "port_", port_extra)):
        prefix = str(out_dir / tag)
        args = [str(a).replace("{o}", prefix) for a in argv]
        outs.append(run(mod, args + list(extra)).replace(prefix, "{o}"))
    return outs


def load_png(path) -> np.ndarray:
    return np.asarray(Image.open(path), np.float32) / 255.0


def assert_frames_close(a, b):
    a, b = load_png(a), load_png(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= MAX_ABS_FRAME
    assert ssim(a, b) >= MIN_SSIM_FRAME


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def assert_svg_close(a, b, rtol=SVG_RTOL):
    """Equal text, with the numbers within ``rtol`` (and 1e-9)."""
    ta, tb = open(a).read(), open(b).read()
    assert _NUM.split(ta) == _NUM.split(tb)
    na = np.array([float(v) for v in _NUM.findall(ta)])
    nb = np.array([float(v) for v in _NUM.findall(tb)])
    np.testing.assert_allclose(nb, na, rtol=rtol, atol=1e-9)


def assert_json_close(got, want, atol):
    """Equal documents, numbers within ``atol`` (a field's range carries
    its measure's bar into a state file's TF domain)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_json_close(got[k], want[k], atol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_json_close(g, w, atol)
    elif isinstance(want, float):
        assert abs(got - want) <= atol, (got, want)
    else:
        assert got == want


# -- the parser ----------------------------------------------------------------

def _tree(parser):
    """{subcommand: {option: (choices, default, required)}}, nested for
    sub-subcommands."""
    out = {}
    for action in parser._actions:
        if action.__class__.__name__ == "_SubParsersAction":
            for name, sub in action.choices.items():
                out[name] = _tree(sub)
        elif action.dest != "help":
            key = action.option_strings[-1] if action.option_strings \
                else action.dest
            out[key] = (tuple(action.choices or ()), action.default,
                        action.required, action.nargs)
    return out


def test_parser_is_jaxs_but_view_plus_device():
    # Since the viewer was ported the parser is JAX's, `view` included, plus
    # --device; the name is kept from when `view` was the one exception.
    want, got = _tree(jax_cli.build_parser()), _tree(cli.build_parser())
    assert set(got) == set(want)
    no_device = {"weights"}
    for name, opts in got.items():
        want_opts = dict(want[name])
        if name not in no_device:
            assert opts.pop("--device") == ((), "cuda", False, None), name
        assert opts == want_opts, name
    assert cli.build_parser().prog == "correrender_tpu_torch"


def test_sampling_method_choices_match_registry():
    from correrender_tpu_torch.diagrams.sampling import SAMPLING_METHODS

    heb = cli.build_parser()._subparsers._group_actions[0].choices["heb"]
    action = next(a for a in heb._actions if a.dest == "sampling_method")
    assert set(action.choices) == set(SAMPLING_METHODS)


def test_main_logs_the_invocation(data_dir, config_dir):
    run(cli, ["info", "--dataset", data_dir / "d.nc", "--device", "cpu"])
    text = (config_dir / "Logfile.html").read_text()
    assert "correrender_tpu_torch info --dataset" in text
    with pytest.raises(FileNotFoundError):
        run(cli, ["info", "--dataset", data_dir / "missing.nc",
                  "--device", "cpu"])
    assert "FileNotFoundError" in (config_dir / "Logfile.html").read_text()


# -- data commands -------------------------------------------------------------

def test_info_equals_jax(data_dir, tmp_path):
    got, want = both(["info", "--dataset", data_dir / "d.nc"], tmp_path)[::-1]
    assert got == want and "members: 15" in got


RENDERS = {
    "dvr": ["--measure", "pearson", "--ref", "3,3,3"],
    "exact_outline": ["--measure", "pearson", "--ref", "3,3,3", "--outline",
                      "--exact-dvr"],
    "legend": ["--measure", "kendall", "--ref", "2,2,2", "--legend"],
    "iso": ["--measure", "spearman", "--ref", "2,2,2", "--renderer",
            "iso_ray", "--iso-value", "0.5"],
    "slice_raw": ["--renderer", "slice", "--member", "3"],
    "ksg": ["--measure", "mi_kraskov", "--kraskov-estimator", "2", "--ref",
            "3,3,3", "--camera", "0.3,0.3,0.7"],
}


@pytest.mark.parametrize("case", list(RENDERS))
def test_render_is_jaxs_within_frame_bars(data_dir, tmp_path, case):
    got, want = both(["render", "--dataset", data_dir / "d.nc", "--size",
                      "48x36", "--output", "{o}o.png", *RENDERS[case]],
                     tmp_path)[::-1]
    assert got == want
    assert_frames_close(tmp_path / "jax_o.png", tmp_path / "port_o.png")


@pytest.mark.parametrize("measure, ext, extra", [
    ("spearman", ".nc", []),
    ("pearson", ".cvol", []),
    ("kendall", ".nc", ["--field-ref", "temp", "--member", "2"]),
])
def test_export_is_jaxs_within_field_bars(data_dir, tmp_path, measure, ext,
                                          extra):
    got, want = both(["export", "--dataset", data_dir / "d.nc", "--measure",
                      measure, "--ref", "2,2,2", "--output", "{o}c" + ext,
                      *extra], tmp_path)[::-1]
    assert got == want
    fields = []
    for tag in ("jax_", "port_"):
        vd = load_volume(str(tmp_path / f"{tag}c{ext}"), device="cpu")
        fields.append(vd.get_field(vd.field_names[0]).numpy())
    assert fields[0].shape == (6, 12, 12)
    np.testing.assert_allclose(fields[1], fields[0], atol=FIELD_BARS[measure])
    assert fields[1][2, 2, 2] == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("ext, extra", [
    (".obj", []), (".obj", ["--technique", "snapmc", "--gamma", "0.3"]),
    (".stl", []), (".tet", ["--iso-value", "0.4"]),
])
def test_mesh_files_equal_jax(data_dir, tmp_path, ext, extra):
    got, want = both(["mesh", "--dataset", data_dir / "d.nc", "--output",
                      "{o}m" + ext, *extra], tmp_path)[::-1]
    assert got == want and "verts" in got
    a = (tmp_path / f"jax_m{ext}").read_bytes()
    b = (tmp_path / f"port_m{ext}").read_bytes()
    assert a == b and len(a) > 84


@pytest.mark.parametrize("extra", [
    ["--downsample", "6", "--max-chords", "10"],
    ["--downsample", "6", "--diagram-type", "matrix"],
    ["--downsample-xyz", "6,6,3", "--sampling-method", "plastic",
     "--num-samples", "16", "--measure", "spearman",
     "--correlation-range", "0.0,0.9", "--color-map", "Cool to Warm"],
])
def test_heb_svg_is_jaxs(data_dir, tmp_path, extra):
    got, want = both(["heb", "--dataset", data_dir / "d.nc", "--output",
                      "{o}h.svg", *extra], tmp_path)[::-1]
    assert got == want
    assert_svg_close(tmp_path / "jax_h.svg", tmp_path / "port_h.svg")


@pytest.mark.parametrize("measure, extra", [
    ("pearson", []),
    ("kendall", ["--all-members"]),
    ("spearman", ["--dataset-b", "{o}../d_b.nc", "--member", "1"]),
])
def test_similarity_is_jaxs(data_dir, tmp_path, measure, extra):
    data = jfixtures.synth_box_ensemble(xs=12, ys=12, zs=6, members=15,
                                        seed=7)
    jax_writers.write_netcdf(str(tmp_path / "d_b.nc"), data[:, None],
                             name="temp")
    extra = [e.replace("{o}../", str(tmp_path) + "/") for e in extra]
    got, want = both(["similarity", "--dataset", data_dir / "d.nc",
                      "--measure", measure, *extra], tmp_path)[::-1]
    value = [float(s.split("=")[1]) for s in (got, want)]
    assert got.split("=")[0] == want.split("=")[0]
    assert abs(value[0] - value[1]) <= max(FIELD_BARS[measure], 1e-6)


@pytest.mark.parametrize("kind, extra", [
    ("scatter", []),
    ("scatter", ["--field-b", "temp", "--member", "4"]),
    ("matrix", ["--measure", "spearman"]),
    ("radar", ["--ref", "2,3,1"]),
    ("radar", ["--equal-steps"]),
    ("timeseries", ["--measure", "pearson"]),
])
def test_diagram_svgs_are_jaxs(data_dir, tmp_path, kind, extra):
    dataset = data_dir / ("ts.nc" if kind == "timeseries" else "d2.nc")
    got, want = both(["diagram", "--dataset", dataset, "--kind", kind,
                      "--output", "{o}g.svg", *extra], tmp_path)[::-1]
    assert got == want
    assert_svg_close(tmp_path / "jax_g.svg", tmp_path / "port_g.svg")


def test_distribution_diagram_has_jaxs_structure(data_dir, tmp_path):
    """t-SNE is unstable at this size in both packages (ROADMAP C): the
    charts hold the same points, not the same places."""
    got, want = both(["diagram", "--dataset", data_dir / "d2.nc", "--kind",
                      "distribution", "--max-points", "60", "--output",
                      "{o}g.svg"], tmp_path)[::-1]
    assert got.split("over")[1] == want.split("over")[1]
    a = (tmp_path / "jax_g.svg").read_text()
    b = (tmp_path / "port_g.svg").read_text()
    assert a.count("<circle") == b.count("<circle") >= 60


# -- scenes --------------------------------------------------------------------

def _state_doc(dataset):
    return {
        "version": 1,
        "dataset": {"filename": str(dataset)},
        "views": [{"camera": {"position": [0.0, 0.2, 0.8]}},
                  {"camera": {"position": [0.5, 0.3, 0.5]}}],
        "calculators": [
            {"type": "correlation", "scalar_field_name": "temp",
             "reference_point_x": 2, "reference_point_y": 2,
             "reference_point_z": 2}],
        "renderers": [
            {"type": "dvr", "view": 0, "field": "Pearson Correlation"},
            {"type": "domain_outline", "view": 1},
            {"type": "iso_ray", "view": 1, "field": "Pearson Correlation",
             "iso_value": 0.4}],
    }


def test_state_renders_and_converts_as_jax(data_dir, tmp_path):
    spath = tmp_path / "s.json"
    spath.write_text(json.dumps(_state_doc(data_dir / "d.nc")))
    got, want = both(["state", "--load", spath, "--size", "48x36",
                      "--output", "{o}sv.png", "--save", "{o}native.json",
                      "--save-reference", "{o}ref.json",
                      "--tf-export", "{o}tf.xml"], tmp_path)[::-1]
    assert got == want and got.count("wrote") == 5
    for view in (0, 1):
        assert_frames_close(tmp_path / f"jax_sv_view{view}.png",
                            tmp_path / f"port_sv_view{view}.png")
    for name in ("native.json", "ref.json"):
        assert json.loads((tmp_path / f"port_{name}").read_text()) == \
            json.loads((tmp_path / f"jax_{name}").read_text()), name
    assert (tmp_path / "port_tf.xml").read_text() == \
        (tmp_path / "jax_tf.xml").read_text()
    # The reference-format file renders again, with a TF from the XML.
    os.replace(tmp_path / "jax_ref.json", tmp_path / "ref.json")
    os.replace(tmp_path / "jax_tf.xml", tmp_path / "tf.xml")
    got, want = both(["state", "--load", tmp_path / "ref.json",
                      "--tf", tmp_path / "tf.xml", "--dock",
                      "--size", "64x36", "--output", "{o}dock.png"],
                     tmp_path)[::-1]
    assert got == want
    assert_frames_close(tmp_path / "jax_dock.png", tmp_path / "port_dock.png")


def test_state_without_output_needs_a_conversion(data_dir, tmp_path):
    spath = tmp_path / "s.json"
    spath.write_text(json.dumps(_state_doc(data_dir / "d.nc")))
    with pytest.raises(SystemExit, match="--output"):
        run(cli, ["state", "--load", spath, "--device", "cpu"])


def test_flythrough_frames_are_jaxs(data_dir, tmp_path):
    got, want = both(["flythrough", "--dataset", data_dir / "d.nc",
                      "--measure", "pearson", "--ref", "3,3,3", "--frames",
                      "3", "--size", "48x36", "--output-dir", "{o}fly"],
                     tmp_path)[::-1]
    assert got == want
    names = sorted(os.listdir(tmp_path / "jax_fly"))
    assert names == sorted(os.listdir(tmp_path / "port_fly"))
    assert len(names) == 3
    for name in names:
        assert_frames_close(tmp_path / "jax_fly" / name,
                            tmp_path / "port_fly" / name)


def test_imgmetrics_is_jaxs(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("CORRERENDER_LPIPS_WEIGHTS", raising=False)
    rng = np.random.default_rng(0)
    a = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    b = np.clip(a + rng.integers(-20, 20, a.shape), 0, 255).astype(np.uint8)
    Image.fromarray(a).save(tmp_path / "a.png")
    Image.fromarray(b).save(tmp_path / "b.png")
    got, want = (json.loads(s) for s in both(
        ["imgmetrics", tmp_path / "a.png", tmp_path / "b.png"],
        tmp_path)[::-1])
    assert got.keys() == want.keys() == {"mse", "psnr", "ssim", "lpips"}
    for k in ("mse", "psnr", "ssim"):
        assert got[k] == want[k]
    assert abs(got["lpips"] - want["lpips"]) <= 2e-6


def test_weights_commands_write_jaxs_files(tmp_path):
    got, want = both(["weights", "lpips", "--alexnet",
                      os.path.join(GOLDENS, "lpips_fixture_alexnet.pth"),
                      "--lpips", os.path.join(GOLDENS,
                                              "lpips_fixture_heads.pth"),
                      "--output", "{o}l.npz"], tmp_path, port_extra=())[::-1]
    assert got == want
    got, want = both(["weights", "convert",
                      os.path.join(GOLDENS, "lpips_fixture_heads.pth"),
                      "{o}c.npz"], tmp_path, port_extra=())[::-1]
    assert got == want and "tensors" in got
    for name in ("l.npz", "c.npz"):
        with np.load(tmp_path / f"jax_{name}") as w, \
                np.load(tmp_path / f"port_{name}") as g:
            assert w.files == g.files
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k])


# -- perf ----------------------------------------------------------------------

def test_default_perf_states_are_jaxs():
    for kw in ({}, {"full": True}, {"fields": ["a", "b"]},
               {"full": True, "fields": ["a"]}):
        got = perf.default_perf_states(**kw)
        want = jax_perf.default_perf_states(**kw)
        assert [vars(s) for s in got] == [vars(s) for s in want]


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


TIMES = ("time_avg_ms", "time_median_ms", "time_min_ms", "time_max_ms")


def test_perf_command_writes_jaxs_columns(data_dir, tmp_path):
    got, want = both(["perf", "--dataset", data_dir / "d.nc", "--frames", "2",
                      "--fields", "temp", "--output", "{o}p.csv"],
                     tmp_path)
    g, w = _csv(tmp_path / "port_p.csv"), _csv(tmp_path / "jax_p.csv")
    assert list(g[0]) == list(w[0]) and len(g) == len(w) == 4
    for rg, rw in zip(g, w):
        for k in rg:
            if k not in TIMES + ("cache_used_mib",):
                assert rg[k] == rw[k], k
        assert float(rg["time_avg_ms"]) > 0
    assert got.count("{") == want.count("{") == 4


def test_perf_sweep_cycles_fields_and_counts_misses():
    data = jfixtures.synth_box_ensemble(xs=16, ys=16, zs=8, members=10)
    vd = VolumeData(GridMetadata(xs=16, ys=16, zs=8, es=10), device="cpu")
    vd.add_field("a", lambda t, e: data[e])
    vd.add_field("b", lambda t, e: data[(e + 1) % 10])
    scene = Scene(vd, views=[Camera(position=(0.0, 0.2, 0.8))])
    states = [perf.PerfState("tiny_dvr", image_size=(32, 32), field="a",
                             num_frames=3),
              perf.PerfState("cycle", image_size=(32, 32), field="a",
                             num_frames=4, cycle_fields=("a", "b"))]
    rows = perf.run_perf_sweep(scene, states)
    assert [r["state"] for r in rows] == ["tiny_dvr", "cycle"]
    assert rows[0]["cache_misses"] == 1 and rows[1]["cache_misses"] == 1
    assert rows[0]["device_mem_mib"] is None
    assert rows[1]["cache_used_mib"] >= rows[0]["cache_used_mib"]


# -- sampling ------------------------------------------------------------------

def _pairs(stack_shape, num_pairs, block, seed):
    """The harness's block pairs (its rng draws, in its order)."""
    rng = np.random.default_rng(seed)
    zs, ys, xs = stack_shape[:3]

    def region():
        x0 = int(rng.integers(0, max(xs - block + 1, 1)))
        y0 = int(rng.integers(0, max(ys - block + 1, 1)))
        z0 = int(rng.integers(0, max(zs - block + 1, 1)))
        return (x0, y0, z0, min(x0 + block - 1, xs - 1),
                min(y0 + block - 1, ys - 1), min(z0 + block - 1, zs - 1))

    return [(region(), region()) for _ in range(num_pairs)]


def _tie_share(stack, pairs):
    """The largest share of one pair's exhaustive values that a single
    value takes (the most a one-ulp move of a found maximum can move its
    rank), over the pairs."""
    share = 0.0
    for ra, rb in pairs:
        truth = sampling_test._ground_truth(
            torch.from_numpy(stack), GridRegion(*ra), GridRegion(*rb),
            "pearson")
        _, counts = np.unique(truth, return_counts=True)
        share = max(share, counts.max() / len(truth))
    return share


def assert_rows_match(got, want, tie_share):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            if k == "time_us":
                continue
            if k == "error_quantile":
                assert abs(float(g[k]) - float(w[k])) <= tie_share + 1e-6
            elif k.startswith("error_"):
                assert abs(float(g[k]) - float(w[k])) <= 1.5e-6, (k, g, w)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_sampling_test_index_is_jaxs(data_dir, tmp_path, index):
    """The four indexed tests, synthetic (0) and on the 12×12×6 fixture
    (1-3), through both CLIs: every default case, bayesian included."""
    block, pairs = 6, 2
    extra = [] if index == 0 else ["--dataset", data_dir / "d.nc"]
    both(["sampling", "--test-index", index, "--num-pairs", pairs,
          "--block", block, "--output", "{o}s.csv", *extra], tmp_path)
    got, want = _csv(tmp_path / "port_s.csv"), _csv(tmp_path / "jax_s.csv")
    if index == 0:
        data = jfixtures.synth_box_ensemble(xs=4 * block, ys=4 * block,
                                            zs=block, members=100)
    else:
        data = jfixtures.synth_box_ensemble(xs=12, ys=12, zs=6, members=15)
    stack = np.ascontiguousarray(np.moveaxis(data, 0, -1))
    assert_rows_match(got, want,
                      _tie_share(stack, _pairs(stack.shape, pairs, block, 0)))
    methods = [r["method"] for r in got]
    assert methods == [c.method for c in (
        sampling_test.DEFAULT_CASES if index < 2 else
        sampling_test._EQUAL_BUDGET_CASES if index == 2 else
        sampling_test._SUBSAMPLED_CASES)]


def test_sampling_cases_are_jaxs(data_dir):
    assert [vars(c) for c in sampling_test.DEFAULT_CASES] == \
        [vars(c) for c in jax_st.DEFAULT_CASES]
    assert [vars(c) for c in sampling_test._SUBSAMPLED_CASES] == \
        [vars(c) for c in jax_st._SUBSAMPLED_CASES]
    with pytest.raises(ValueError, match="data-driven"):
        sampling_test.run_sampling_test_index(1, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        sampling_test.run_sampling_test_index(
            7, dataset=str(data_dir / "d.nc"), device="cpu")


def test_evaluate_case_refuses_a_pair_without_finite_values():
    stack = np.zeros((4, 4, 4, 8), np.float32)
    region = GridRegion(0, 0, 0, 1, 1, 1)
    with pytest.raises(ValueError, match="non-finite"):
        sampling_test.evaluate_case(torch.from_numpy(stack), region, region,
                                    sampling_test.DEFAULT_CASES[0])
    with pytest.raises(ValueError, match="non-finite"):
        jax_st.evaluate_case(stack, JaxRegion(0, 0, 0, 1, 1, 1),
                             JaxRegion(0, 0, 0, 1, 1, 1),
                             jax_st.DEFAULT_CASES[0])


def test_screened_sampling_rows_are_jaxs(tmp_path):
    """The screened harness on 16 pairs of 4³ blocks. Its GP-UCB rows are
    held by the batched sampler's rule for rounding ties
    (``test_batched_bayopt_matches_jax_but_for_rounding_ties``): a pair
    whose GP takes the other branch of a tie departs, with both maxima
    between the pair's initial samples and its exhaustive maximum; the
    full-GP row then differs from JAX's by those pairs' share alone."""
    from correrender_tpu.diagrams import bayopt as jax_bayopt
    from correrender_tpu_torch.diagrams import bayopt, sampling

    kw = dict(num_pairs=16, block=4, num_samples=24, num_init=8)
    want = jax_st.run_screened_sampling_tests(
        csv_path=str(tmp_path / "j.csv"), **kw)
    got = sampling_test.run_screened_sampling_tests(
        csv_path=str(tmp_path / "p.csv"), device="cpu", **kw)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["method"] for r in got] == ["bayesian_full",
                                          "bayesian_screened",
                                          "plastic_budget"]
    assert got[1]["top_frac"] == want[1]["top_frac"]
    assert got[2]["budget_samples"] >= kw["num_samples"]
    assert open(tmp_path / "p.csv").readline() == \
        open(tmp_path / "j.csv").readline()
    # The full GP's values pair by pair, and the row they make.
    data = jfixtures.synth_box_ensemble(xs=24, ys=24, zs=8, members=100)
    stack = np.ascontiguousarray(np.moveaxis(data, 0, -1))
    pairs = _pairs(stack.shape, 16, 4, 0)
    ra, rb = [GridRegion(*a) for a, _ in pairs], [GridRegion(*b)
                                                  for _, b in pairs]
    g = bayopt.batched_bayesian_opt_max(torch.from_numpy(stack), ra, rb,
                                        num_init=8, num_iters=16)
    w = np.asarray(jax_bayopt.batched_bayesian_opt_max(
        stack, [JaxRegion(*a) for a, _ in pairs],
        [JaxRegion(*b) for _, b in pairs], num_init=8, num_iters=16))
    departs = np.flatnonzero(np.abs(g - w) > 2e-5)
    assert len(departs) <= 3, departs
    init = sampling.batched_block_pairs_max(
        torch.from_numpy(stack), [ra[k] for k in departs],
        [rb[k] for k in departs], method="plastic", num_samples=8)
    shift = {"error_quantile": 0.0, "error_linear": 0.0,
             "error_absolute": 0.0}
    for k, first in zip(departs, init):
        truth = sampling_test._ground_truth(torch.from_numpy(stack), ra[k],
                                            rb[k], "pearson")
        for v in (g[k], w[k]):
            assert first - 2e-5 <= v <= truth[-1] + 1e-5
        n, span = len(truth), truth[-1] - truth[0]
        ranks = np.searchsorted(truth, [g[k], w[k]], side="right")
        shift["error_quantile"] += abs(ranks[0] - ranks[1]) / n / 16
        shift["error_linear"] += abs(g[k] - w[k]) / span / 16
        shift["error_absolute"] += abs(g[k] - w[k]) / 16
    tie = _tie_share(stack, pairs)
    for key, bound in shift.items():
        assert abs(got[0][key] - want[0][key]) <= bound + tie + 1.5e-6, key
    for row in got:
        assert 0.0 <= row["error_quantile"] <= 1.0


# -- replicability -------------------------------------------------------------

def test_replicability_files_are_jaxs_and_load_back(tmp_path):
    want = jax_rep.run_replicability(str(tmp_path / "jax"),
                                     image_size=(48, 36))
    got = replicability.run_replicability(str(tmp_path / "port"),
                                          image_size=(48, 36), device="cpu")
    names = [os.path.basename(f) for f in got]
    assert names == [os.path.basename(f) for f in want]
    for g, w in zip(got, want):
        if g.endswith(".png"):
            assert_frames_close(w, g)
        elif g.endswith(".svg"):
            assert_svg_close(w, g)
        elif g.endswith(".nc"):
            assert open(g, "rb").read() == open(w, "rb").read()
        else:
            gd = json.loads(open(g).read().replace(str(tmp_path / "port"),
                                                   "D"))
            wd = json.loads(open(w).read().replace(str(tmp_path / "jax"),
                                                   "D"))
            assert_json_close(gd, wd, FIELD_BARS["pearson"])
    for state in got[-2:]:
        scene = Scene.load_state(state, device="cpu")
        img = scene.render_view(0, image_size=(48, 36))
        assert img.shape == (36, 48, 4) and bool(torch.isfinite(img).all())
    # The native file's frame is the run's own first view.
    scene = Scene.load_state(got[-2], device="cpu")
    Image.fromarray((np.clip(scene.render_view(0, image_size=(48, 36))
                             .numpy(), 0, 1) * 255).astype(np.uint8)).save(
        tmp_path / "again.png")
    assert_frames_close(got[0], tmp_path / "again.png")


def test_replicability_command(tmp_path):
    out = run(cli, ["replicability", "--output-dir", tmp_path / "r",
                    "--device", "cpu"])
    assert out.count("wrote") == 6
    assert load_png(tmp_path / "r" / "replicability_view0.png").shape == \
        (600, 800, 4)


# -- run_all and the package exports -------------------------------------------

CONFIGS = ("config1_synth_box_pearson_dvr", "config2_rank_correlations",
           "config3_mutual_information", "config4_timelag_zarr_flythrough",
           "config5_sharded_batch_render")


def fake_config(name, seen, raises=None):
    def fake(**kwargs):
        seen.append((name, kwargs))
        if raises:
            raise raises
        return {"config": name[len("configN_"):], "ms": 1.5,
                "grid": [4, 4, 2], "stack": torch.zeros(3),
                "frames": [torch.zeros(2)], "cameras": [Camera()]}

    fake.__name__ = name
    return fake


def test_run_all_records_each_row_in_order(monkeypatch, tmp_path, capsys):
    from correrender_tpu_torch.app import baseline_configs as bc

    seen = []
    for name in CONFIGS:
        monkeypatch.setattr(bc, name, fake_config(
            name, seen, RuntimeError("boom") if "config2" in name else None))
    out = tmp_path / "res" / "rows.json"
    rows = bc.run_all(str(out), device="cuda:3")
    assert [name for name, _ in seen] == list(CONFIGS)  # all run, in order
    assert all(kw["device"] == "cuda:3" for _, kw in seen)
    assert seen[3][1]["tmp_dir"] == str(tmp_path / "res" / "config4")
    assert seen[4][1]["tmp_dir"] == str(tmp_path / "res" / "config5")
    assert rows[1] == {"config": "config2_rank_correlations",
                       "error": "RuntimeError: boom",
                       "wall_s": rows[1]["wall_s"]}
    for i in (0, 2, 3, 4):  # tensors, frames and cameras dropped
        assert set(rows[i]) == {"config", "ms", "grid", "wall_s"}
        assert rows[i]["ms"] == 1.5 and rows[i]["grid"] == [4, 4, 2]
    assert all(0 <= r["wall_s"] < 5 for r in rows)
    assert json.loads(out.read_text()) == rows
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in printed[-5:]] == rows


def test_run_all_writes_under_build_by_default(monkeypatch, tmp_path):
    from correrender_tpu_torch import native
    from correrender_tpu_torch.app import baseline_configs as bc

    assert bc.RESULTS_PATH.parent.parent == native.BUILD_ROOT
    assert bc.RESULTS_PATH.name == "BASELINE_RESULTS.json"
    seen = []
    for name in CONFIGS:
        monkeypatch.setattr(bc, name, fake_config(name, seen))
    monkeypatch.setattr(bc, "RESULTS_PATH", tmp_path / "b" / "r.json")
    rows = bc.run_all()
    assert json.loads((tmp_path / "b" / "r.json").read_text()) == rows
    assert seen[0][1] == {"device": "cuda"}


def test_run_all_on_the_cpu_refuses_the_timed_configs(monkeypatch,
                                                      tmp_path):
    from correrender_tpu_torch.app import baseline_configs as bc

    # Config 5 at its CPU size warps eight 1280x720 frames (about a
    # minute on one thread): a fake stands in; config 4 runs.
    seen = []
    monkeypatch.setattr(bc, CONFIGS[4], fake_config(CONFIGS[4], seen))
    rows = bc.run_all(str(tmp_path / "r.json"), device="cpu")
    for i, row in enumerate(rows[:3]):
        assert row == {
            "config": CONFIGS[i], "wall_s": row["wall_s"],
            "error": f"ValueError: config {i + 1} is timed with CUDA "
                     "events: pass a CUDA device, not cpu"}
    assert rows[3]["config"] == "timelag_zarr_flythrough"
    assert rows[3]["device"] == "cpu" and rows[3]["total_ms"] > 0
    assert all(os.path.exists(f) for f in rows[3]["frames"])
    assert seen == [(CONFIGS[4], {"device": "cpu",
                                  "tmp_dir": str(tmp_path / "config5")})]


def jax_all(package: str) -> list:
    import ast

    path = os.path.join(os.path.dirname(__file__), "..", "correrender_tpu",
                        package, "__init__.py")
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            return [e.value for e in node.value.elts]
    raise AssertionError(f"no __all__ in {path}")


EXPORTS = [
    ("render", "Camera", "render.camera"),
    ("render", "orbit_camera", "render.camera"),
    ("render", "TransferFunction", "render.tf"),
    ("render", "dvr_render", "render.dvr"),
    ("render", "sample_trilinear", "render.sampling"),
    ("render", "dvr_shearwarp", "render.dvr_fast"),
    ("render", "iso_render", "render.iso"),
    ("render", "world_map_render", "render.worldmap"),
    ("app", "Scene", "app.state"),
    ("app", "RENDERING_MODE_IDS", "app.state"),
    ("app", "perf", "app"),
    ("app", "sampling_test", "app"),
    ("app", "replicability", "app"),
    ("io", "writers", "io"),
]


@pytest.mark.parametrize("package, name, home", EXPORTS,
                         ids=[f"{p}.{n}" for p, n, _ in EXPORTS])
def test_package_exports_are_the_modules_objects(package, name, home):
    import importlib

    pkg = importlib.import_module(f"correrender_tpu_torch.{package}")
    got = getattr(pkg, name)
    if home == package:  # a submodule
        assert got is importlib.import_module(
            f"correrender_tpu_torch.{package}.{name}")
    else:
        assert got is getattr(importlib.import_module(
            f"correrender_tpu_torch.{home}"), name)


@pytest.mark.parametrize("package", ["render", "app", "io"])
def test_package_all_keeps_jaxs_names(package):
    import importlib

    pkg = importlib.import_module(f"correrender_tpu_torch.{package}")
    assert set(jax_all(package)) <= set(pkg.__all__)
    if package != "io":  # the port's io also exports open_dataset
        assert pkg.__all__ == jax_all(package)
    with pytest.raises(AttributeError):
        getattr(pkg, "no_such_export")


def test_readme_import_of_the_render_package():
    from correrender_tpu_torch.render import Camera, TransferFunction
    from correrender_tpu_torch.render.camera import Camera as C
    from correrender_tpu_torch.render.tf import TransferFunction as T

    assert Camera is C and TransferFunction is T
