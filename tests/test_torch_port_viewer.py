"""PyTorch port (``correrender_tpu_torch``) vs the JAX package: the
interactive viewer (``app/viewer.py``) and the CLI's ``view``.

Every case runs one scripted session through both viewers, on scenes
built in each package from the same numpy arrays (``tests/test_viewer.py``'s
scene: 16×16×8, 16 members of ``synth_box_ensemble``, the reference point
at (4, 4, 4), one ``dvr`` of the Pearson field), over loopback HTTP on
ephemeral ports where JAX's own test drives HTTP. The cases are the
counterparts of JAX's viewer tests (``tests/test_viewer.py``, and the
viewer's cases in ``tests/test_aux.py`` and ``tests/test_state_ref.py``),
each asserting what JAX's asserts, on the port's side, and:

- frames, decoded from the PNGs, within the frame bars (max-abs 1e-2,
  SSIM 0.995);
- status codes, content types and JSON replies equal, apart from the
  timing fields (``render_ms``, ``overlay_ms``, ``encode_ms``,
  ``total_ms``: both non-negative) and floats, which may differ by the
  fields' rounding (``FLOAT_BAR``; a chord's value is rounded to 4
  decimals, so an ulp across a rounding boundary moves it by 1e-4);
- error replies and error messages equal;
- SVGs equal but for numbers within 1e-5 relative (t-SNE charts by their
  structure: ROADMAP C).

The port departs from JAX in two places, each pinned here: a cached
``/frame`` reports ``X-Server-Frame-Ms: 0.0`` (JAX reports the previous
frame's cost, ADVICE #3), and no thread warms the other measures (JAX's
``warm_measures``: the port compiles nothing per measure).
"""

import copy
import io
import json
import re
import threading
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from PIL import Image

from correrender_tpu.app import cli as jax_cli
from correrender_tpu.app import viewer as jax_viewer
from correrender_tpu.app.state import Scene as JaxScene
from correrender_tpu.calculators.correlation import (
    CorrelationCalculator as JaxCalc,
)
from correrender_tpu.core.fields import GridMetadata as JaxGrid
from correrender_tpu.core.fields import VolumeData as JaxVolumeData
from correrender_tpu.io import writers as jax_writers
from correrender_tpu.render.camera import Camera as JaxCamera
from correrender_tpu.utils import fixtures as jfixtures

from correrender_tpu_torch.app import cli
from correrender_tpu_torch.app import viewer
from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.calculators.correlation import (
    CorrelationCalculator,
)
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.io import load_volume
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.utils.metrics import ssim

MAX_ABS_FRAME = 1e-2
MIN_SSIM_FRAME = 0.995
FLOAT_BAR = 1e-4
SVG_RTOL = 1e-5
TIMING_KEYS = ("render_ms", "overlay_ms", "encode_ms", "total_ms")
HTTP_IMAGE = (96, 72)  # tests/test_viewer.py's server
APP_IMAGE = (64, 48)  # and its direct apps
MEASURES = ("pearson", "spearman", "kendall", "mi_binned", "mi_kraskov",
            "binned_mi_correlation_coefficient",
            "kmi_correlation_coefficient")


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
    monkeypatch.setenv("CORRERENDER_CONFIG_DIR", str(tmp_path / "config"))


# -- comparisons --------------------------------------------------------------

def decode(png: bytes) -> np.ndarray:
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    return np.asarray(Image.open(io.BytesIO(png)), np.float32) / 255.0


def assert_frames_close(got: bytes, want: bytes):
    a, b = decode(got), decode(want)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= MAX_ABS_FRAME
    assert ssim(a, b) >= MIN_SSIM_FRAME


def assert_reply_equal(got, want, path="reply"):
    """Equal JSON documents but for the timing fields and float rounding."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got,
                                                                 want)
        for k in want:
            if k in TIMING_KEYS:
                assert isinstance(got[k], float) and got[k] >= 0.0, path
            else:
                assert_reply_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), (path, got, want)
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_reply_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (float, int)) and not isinstance(got, bool)
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= \
            FLOAT_BAR + 1e-12, (path, got, want)
    else:
        assert got == want, (path, got, want)


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def assert_svgs_alike(got: str, want: str, kind: str):
    assert "<svg" in got[:200]
    if kind == "distribution":
        # t-SNE at a few hundred points moves with any rounding (ROADMAP
        # C): the same points, not the same places.
        assert got.count("<circle") == want.count("<circle") > 0
        return
    assert _NUM.split(got) == _NUM.split(want)
    np.testing.assert_allclose(
        np.array([float(v) for v in _NUM.findall(got)]),
        np.array([float(v) for v in _NUM.findall(want)]),
        rtol=SVG_RTOL, atol=1e-9)


def raise_alike(jax_fn, port_fn, exc=ValueError):
    """Both calls raise ``exc`` with the same message; returns it."""
    with pytest.raises(exc) as want:
        jax_fn()
    with pytest.raises(exc) as got:
        port_fn()
    assert str(got.value) == str(want.value)
    return str(got.value)


# -- scenes -------------------------------------------------------------------

def box_data(members=16, seed=0):
    return jfixtures.synth_box_ensemble(xs=16, ys=16, zs=8, members=members,
                                        seed=seed)


def scenes(fields=None, grid=None, cameras=((0.0, 0.2, 0.8),),
           calculator=True, renderer=True):
    """A JAX and a port Scene over the same providers. ``fields`` maps a
    name to a ``(time, member) -> array`` provider (default: the box
    ensemble as "data"); the calculator correlates the first field."""
    if fields is None:
        data = box_data()
        fields = {"data": lambda t, e: data[e]}
    grid = grid or dict(xs=16, ys=16, zs=8, es=16)
    out = []
    for Vd, Grid, Sc, Cam, Calc, kw in (
            (JaxVolumeData, JaxGrid, JaxScene, JaxCamera, JaxCalc, {}),
            (VolumeData, GridMetadata, Scene, Camera, CorrelationCalculator,
             {"device": "cpu"})):
        vd = Vd(Grid(**grid), **kw)
        for name, provider in fields.items():
            vd.add_field(name, provider)
        scene = Sc(vd, views=[Cam(position=p) for p in cameras])
        field = next(iter(fields))
        if calculator:
            field = scene.add_calculator(Calc(field,
                                              reference_point=(4, 4, 4)))
        if renderer:
            scene.add_renderer("dvr", field=field)
        out.append(scene)
    return tuple(out)


class AppPair:
    """JAX's ViewerApp and the port's, driven by direct calls."""

    def __init__(self, jax_scene, port_scene, image_size=APP_IMAGE):
        self.jax = jax_viewer.ViewerApp(jax_scene, image_size=image_size,
                                        warm_measures=False)
        self.port = viewer.ViewerApp(port_scene, image_size=image_size)

    def api(self, cmd: dict) -> dict:
        want = self.jax.api(copy.deepcopy(cmd))
        got = self.port.api(copy.deepcopy(cmd))
        assert_reply_equal(got, want)
        return got

    def frame(self) -> bytes:
        want, got = self.jax.frame_png(), self.port.frame_png()
        assert_frames_close(got, want)
        return got

    def diagram(self, kind: str, params=None) -> str:
        want = self.jax.diagram_svg(kind, dict(params or {}))
        got = self.port.diagram_svg(kind, dict(params or {}))
        assert_svgs_alike(got, want, kind)
        return got

    def close(self):
        self.jax.close()


def _request(req):
    """(status, content type, body, headers), HTTP errors included."""
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read(), e.headers


class HttpPair:
    """Both viewers' servers on ephemeral loopback ports."""

    def __init__(self, jax_base, port_base, jax_app, port_app):
        self.bases = (jax_base, port_base)
        self.jax, self.port = jax_app, port_app
        self.headers = None

    def _both(self, make):
        want, got = (_request(make(base)) for base in self.bases)
        assert got[0] == want[0], (got[:3], want[:3])
        assert got[1] == want[1]
        self.headers = (want[3], got[3])
        return got, want

    def get(self, path):
        """GET ``path`` from both; JSON and text bodies must be equal."""
        got, want = self._both(lambda base: base + path)
        if got[1] == "application/json":
            assert_reply_equal(json.loads(got[2]), json.loads(want[2]))
        elif got[1] != "image/png" and not got[1].startswith("image/svg"):
            assert got[2] == want[2]
        return got[:3], want[:3]

    def post(self, body: bytes, ctype="application/json"):
        got, want = self._both(lambda base: urllib.request.Request(
            base + "/api", data=body, headers={"Content-Type": ctype},
            method="POST"))
        assert_reply_equal(json.loads(got[2]), json.loads(want[2]))
        return got[0], json.loads(got[2])

    def api(self, cmd: dict) -> dict:
        status, reply = self.post(json.dumps(cmd).encode())
        assert status == 200
        return reply

    def frame(self) -> bytes:
        got, want = self.get("/frame")
        assert got[0] == 200 and got[1] == "image/png"
        assert_frames_close(got[2], want[2])
        return got[2]

    def diagram(self, query: str):
        got, want = self.get("/diagram?" + query)
        if got[0] == 200:
            assert got[1] == "image/svg+xml"
            assert_svgs_alike(got[2].decode(), want[2].decode(),
                              "heb" if "kind=heb" in query else "other")
        return got


@contextmanager
def http_pair(jax_scene=None, port_scene=None, image_size=HTTP_IMAGE):
    if jax_scene is None:
        jax_scene, port_scene = scenes()
    servers = [
        jax_viewer.make_server(jax_scene, port=0, image_size=image_size,
                               warm_measures=False),
        viewer.make_server(port_scene, port=0, image_size=image_size),
    ]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s, _ in servers]
    for t in threads:
        t.start()
    bases = ["http://%s:%d" % s.server_address for s, _ in servers]
    try:
        yield HttpPair(*bases, servers[0][1], servers[1][1])
    finally:
        for (s, app), t in zip(servers, threads):
            s.shutdown()
            s.server_close()
            t.join(timeout=10)
        servers[0][1].close()


def port_calc(app):
    return next(iter(app.scene.volume_data.calculators.values()))


# -- the cases ----------------------------------------------------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


@case
def index_and_info(tmp_path):
    with http_pair() as pair:
        (status, ctype, body), _ = pair.get("/")
        assert status == 200 and ctype.startswith("text/html")
        assert b"correrender_tpu" in body
        info = pair.api({"op": "info"})
        assert info["ok"]
        assert info["grid"] == {"xs": 16, "ys": 16, "zs": 8, "ts": 1,
                                "es": 16}
        assert "pearson" in info["measures"]
        assert info["reference_point"] == [4, 4, 4]
        assert info["measure"] == "pearson"


@case
def frame_is_png(tmp_path):
    with http_pair() as pair:
        assert pair.frame()[:8] == b"\x89PNG\r\n\x1a\n"


@case
def orbit_changes_frame(tmp_path):
    with http_pair() as pair:
        before = pair.frame()
        assert pair.api({"op": "orbit", "dtheta": 1.2, "dphi": 0.3})["ok"]
        assert pair.frame() != before


@case
def pick_moves_reference_point(tmp_path):
    with http_pair() as pair:
        reply = pair.api({"op": "pick", "px": 48, "py": 36})
        assert reply["ok"], reply
        ref = reply["reference_point"]
        assert tuple(ref) == port_calc(pair.port).reference_point
        assert tuple(ref) != (4, 4, 4)
        pair.frame()


@case
def pick_miss_reports_error(tmp_path):
    with http_pair() as pair:
        pair.api({"op": "zoom", "factor": 10.0})
        reply = pair.api({"op": "pick", "px": 0, "py": 0})
        assert not reply["ok"] and "miss" in reply["error"]


@case
def pick_clamps_edge_pixels(tmp_path):
    with http_pair() as pair:
        reply = pair.api({"op": "pick", "px": 96, "py": 72})
        assert "error" not in reply or "miss" in reply.get("error", "")


@case
def pick_scroll_scrubs_depth(tmp_path):
    with http_pair() as pair:
        reply = pair.api({"op": "pick", "px": 48, "py": 36})
        assert reply["ok"], reply
        entry = reply["reference_point"]
        reply = pair.api({"op": "pick_scroll", "amount": 0.5})
        assert reply["ok"] and reply["reference_point"] != entry
        pair.frame()
        far = pair.api({"op": "pick_scroll", "amount": 100.0})
        g = pair.port.scene.volume_data.grid
        x, y, z = far["reference_point"]
        assert 0 <= x < g.xs and 0 <= y < g.ys and 0 <= z < g.zs
        back = pair.api({"op": "pick_scroll", "amount": -100.0})
        assert back["reference_point"] == entry


@case
def pick_scroll_without_pick_errors(tmp_path):
    with http_pair() as pair:
        reply = pair.api({"op": "pick_scroll", "amount": 0.5})
        assert not reply["ok"] and "pick" in reply["error"]


@case
def get_api_is_read_only(tmp_path):
    with http_pair() as pair:
        (status, _, body), _ = pair.get("/api?op=info")
        assert status == 200 and b'"grid"' in body
        (status, _, _), _ = pair.get(
            "/api?op=set_option&key=legend&value=false")
        assert status == 403
        assert pair.port.show_legend


@case
def post_requires_json_content_type(tmp_path):
    with http_pair() as pair:
        status, reply = pair.post(
            b'{"op": "set_option", "key": "legend", "value": false}',
            ctype="text/plain")
        assert status == 415 and not reply["ok"]
        assert pair.port.show_legend


@case
def set_measure_and_field(tmp_path):
    with http_pair() as pair:
        before = pair.frame()
        assert pair.api({"op": "set_measure", "measure": "kendall"})["ok"]
        calc = port_calc(pair.port)
        assert calc.measure.value == "kendall"
        assert pair.port.scene.renderers[0]["field"] == calc.output_name
        assert calc.output_name in pair.port.scene.volume_data.field_names
        assert pair.frame() != before
        assert not pair.api({"op": "set_field", "field": "nope"})["ok"]
        reply = pair.api({"op": "set_field", "field": calc.output_name})
        assert not reply["ok"] and "derived" in reply["error"]


@case
def set_field_preserves_separate_reference(tmp_path):
    data = box_data()
    other = box_data(seed=7)
    third = box_data(seed=8)
    js, ts = scenes({"data": lambda t, e: data[e],
                     "other": lambda t, e: other[e],
                     "third": lambda t, e: third[e]})
    for sc in (js, ts):
        next(iter(sc.volume_data.calculators.values())).field_name_ref = \
            "other"  # separate fields
    pair = AppPair(js, ts)
    pair.frame()  # separate fields: both take the Scene path
    assert pair.api({"op": "set_field", "field": "third"})["ok"]
    calc = port_calc(pair.port)
    assert calc.field_name == "third" and calc.field_name_ref == "other"
    pair.frame()
    for sc in (js, ts):
        next(iter(sc.volume_data.calculators.values())).field_name_ref = \
            "third"  # single mode follows the query field
    assert pair.api({"op": "set_field", "field": "data"})["ok"]
    assert calc.field_name_ref == "data"
    pair.frame()


@case
def unknown_op(tmp_path):
    with http_pair() as pair:
        reply = pair.api({"op": "warp_core_breach"})
        assert not reply["ok"] and "unknown op" in reply["error"]


@case
def diagram_endpoint(tmp_path):
    with http_pair() as pair:
        q = "kind=heb&downsample=4&num_samples=6&max_chords=20"
        status, ctype, body = pair.diagram(q)
        assert status == 200 and b"<svg" in body[:200]
        assert pair.diagram(q)[2] == body  # cached per epoch
        status, _, body = pair.diagram("kind=scatter")
        assert status == 200 and b"<svg" in body[:200]
        status, _, fbody = pair.diagram(
            q + "&correlation_range=0.99999,1&cell_distance_range=50,60")
        assert status == 200 and b"<title>" not in fbody
        assert pair.diagram("kind=nope")[0] == 400
        assert pair.diagram("kind=timeseries")[0] == 400
        status, _, body = pair.diagram("kind=matrix")
        assert status == 200 and b"<svg" in body[:200]


def _series_scene(ts=12, seed=3, nan=False, correlated=True):
    rng = np.random.default_rng(seed)
    base_sig = rng.normal(size=ts).astype(np.float32)
    vols = []
    for t in range(ts):
        v = rng.normal(size=(4, 8, 8)).astype(np.float32)
        if correlated:
            v = v * 0.1
            v[:, :4] += base_sig[t]  # a correlated half of the domain
        if nan and t == 2:
            v[:] = np.nan  # every cell NaN at one time step
        vols.append(v)
    return scenes({"f": lambda t, e: vols[t]},
                  grid=dict(xs=8, ys=8, zs=4, es=1, ts=ts), calculator=False)


@case
def timeseries_diagram_multistep(tmp_path):
    pair = AppPair(*_series_scene())
    svg = pair.diagram("timeseries", {"downsample": 4})
    assert "<svg" in svg and "rect" in svg
    assert "<svg" in pair.diagram("timeseries", {"downsample": 4,
                                                 "window": 6})
    pair.close()


@case
def not_found_is_404(tmp_path):
    with http_pair() as pair:
        (status, _, body), _ = pair.get("/nothing")
        assert status == 404 and body == b"not found"
        got, want = pair._both(lambda base: urllib.request.Request(
            base + "/elsewhere", data=b"{}",
            headers={"Content-Type": "application/json"}, method="POST"))
        assert got[0] == want[0] == 404 and got[2] == want[2]


@case
def zoom_and_clamps(tmp_path):
    pair = AppPair(*scenes())
    r0 = pair.port._radius
    assert pair.api({"op": "zoom", "factor": 0.5})["ok"]
    assert pair.port._radius == pytest.approx(r0 * 0.5)
    pair.api({"op": "zoom", "factor": 1e-9})
    assert pair.port._radius == 0.05
    pair.frame()
    pair.api({"op": "set_time", "time": 99})
    assert pair.port.scene.current_time == 0  # ts = 1, clamped
    pair.api({"op": "set_member", "member": 99})
    assert pair.port.scene.current_member == 15


@case
def camera_checkpoint_roundtrip(tmp_path):
    pair = AppPair(*scenes())
    pair.api({"op": "checkpoint_save", "name": "home"})
    pair.api({"op": "orbit", "dtheta": 1.0, "dphi": 0.2})
    moved = np.asarray(pair.port.scene.views[0].position)
    pair.frame()
    reply = pair.api({"op": "checkpoint_restore", "name": "home"})
    assert reply["ok"] and reply["frame_epoch"] > 0
    home = np.asarray(pair.port.scene.views[0].position)
    assert not np.allclose(moved, home)
    pair.frame()
    assert not pair.api({"op": "checkpoint_restore", "name": "nope"})["ok"]
    assert pair.api({"op": "info"})["checkpoints"] == ["home"]


@case
def set_colormap_and_options(tmp_path):
    pair = AppPair(*scenes())
    assert pair.api({"op": "set_colormap", "colormap": "viridis"})["ok"]
    assert pair.api({"op": "set_option", "key": "legend",
                     "value": False})["ok"]
    assert not pair.port.show_legend
    pair.frame()
    assert not pair.api({"op": "set_option", "key": "nope", "value": 1})["ok"]
    assert pair.api({"op": "set_option", "key": "image_size",
                     "value": [32, 24]})["ok"]
    assert pair.port.image_size == (64, 48)  # clamped to the minimum
    for key in ("refpoints", "pick_mode", "legend"):
        assert pair.api({"op": "set_option", "key": key,
                         "value": True})["ok"]
    assert pair.api({"op": "set_option", "key": "image_size",
                     "value": [80, 60]})["ok"]
    pair.frame()


@case
def set_renderer_and_options(tmp_path):
    pair = AppPair(*scenes())
    assert pair.api({"op": "set_renderer", "renderer": "iso_ray"})["ok"]
    assert pair.port.scene.renderers[0]["type"] == "iso_ray"
    assert pair.api({"op": "set_renderer_option", "key": "iso_value",
                     "value": 0.3})["ok"]
    assert pair.port.scene.renderers[0]["iso_value"] == 0.3
    pair.frame()
    assert pair.api({"op": "set_renderer", "renderer": "slice"})["ok"]
    assert pair.api({"op": "set_renderer_option", "key": "axis",
                     "value": "y"})["ok"]
    assert pair.api({"op": "set_renderer_option", "key": "position",
                     "value": 1.7})["ok"]
    assert pair.port.scene.renderers[0]["position"] == 1.0  # clamped
    assert pair.api({"op": "set_renderer_option", "key": "position",
                     "value": 0.4})["ok"]
    pair.frame()
    assert not pair.api({"op": "set_renderer", "renderer": "nope"})["ok"]
    assert not pair.api({"op": "set_renderer_option", "key": "nope",
                         "value": 1})["ok"]
    assert not pair.api({"op": "set_renderer_option", "key": "axis",
                         "value": "w"})["ok"]


@case
def set_tf_and_absolute(tmp_path):
    pair = AppPair(*scenes())
    calc = port_calc(pair.port)
    name = calc.output_name
    assert pair.api({"op": "set_tf", "opacity_points": [
        [0, 0.1], [0.5, 0.9], [1, 0.1]]})["ok"]
    tf1 = pair.port.scene.transfer_functions[name]
    info = pair.api({"op": "info"})
    assert info["opacity_points"] == [[0, 0.1], [0.5, 0.9], [1, 0.1]]
    assert info["opacity_default"] is False
    pair.frame()
    assert not pair.api({"op": "set_tf", "opacity_points": [[0, 2.0]]})["ok"]
    assert not pair.api({"op": "set_tf", "opacity_points": [
        [0.9, 0.1], [0.1, 0.2]]})["ok"]
    assert pair.api({"op": "set_tf", "opacity_points": None})["ok"]
    assert pair.api({"op": "info"})["opacity_default"] is True
    assert pair.port.scene.transfer_functions[name] is not tf1
    assert pair.api({"op": "set_absolute", "value": True})["ok"]
    assert calc.absolute is True and pair.api({"op": "info"})["absolute"]
    assert pair.port.scene.volume_data.get_min_max(name)[0] >= 0.0
    pair.frame()


@case
def set_colormap_unknown_rejected(tmp_path):
    pair = AppPair(*scenes())
    assert not pair.api({"op": "set_colormap", "colormap": "nope"})["ok"]
    assert pair.api({"op": "set_colormap", "colormap": "viridis"})["ok"]
    assert pair.api({"op": "info"})["colormap"] == "viridis"
    pair.frame()


@case
def fused_path_matches_scene_render(tmp_path):
    js, ts = scenes()
    pair = AppPair(js, ts, image_size=(96, 72))
    jobs = pair.jax._fused_dvr_job(), pair.port._fused_dvr_job()
    assert None not in jobs
    fused = pair.port._render_fused(*jobs[1])
    want = np.asarray(pair.jax._render_fused(*jobs[0]))
    assert np.abs(fused.numpy() - want).max() <= MAX_ABS_FRAME
    composed = ts.render_view(0, image_size=(96, 72), fast_dvr=True)
    assert fused.shape == composed.shape
    assert float((fused - composed).abs().max()) < 0.05
    # Each refusal sends both viewers to the Scene.
    for sc in (js, ts):
        next(iter(sc.volume_data.calculators.values())) \
            .use_render_restriction = True
    assert pair.jax._fused_dvr_job() is pair.port._fused_dvr_job() is None
    pair.frame()
    for sc in (js, ts):
        next(iter(sc.volume_data.calculators.values())) \
            .use_render_restriction = False
    assert pair.port._fused_dvr_job() is not None
    for sc in (js, ts):
        sc.add_renderer("domain_outline")
    assert pair.jax._fused_dvr_job() is pair.port._fused_dvr_job() is None
    pair.api({"op": "orbit", "dtheta": 0.2})
    pair.frame()


@case
def frame_cache_serves_unchanged_frames(tmp_path):
    pair = AppPair(*scenes())
    p1 = pair.frame()
    assert pair.port.frame_png() is p1  # the cached bytes, no render
    pair.api({"op": "orbit", "dtheta": 0.5})
    p2 = pair.frame()
    assert p2 != p1  # the epoch's bump invalidates


@case
def save_state(tmp_path):
    pair = AppPair(*scenes())
    pair.frame()
    paths = tmp_path / "jax.json", tmp_path / "port.json"
    want = pair.jax.api({"op": "save_state", "path": str(paths[0])})
    got = pair.port.api({"op": "save_state", "path": str(paths[1])})
    assert got == {"path": str(paths[1]), "ok": True}
    assert want == {"path": str(paths[0]), "ok": True}
    docs = [json.loads(p.read_text()) for p in paths]
    assert "calculators" in docs[1]
    assert_reply_equal(docs[1], docs[0])


@case
def no_thread_warms_the_measures(tmp_path):
    # JAX's test_measure_warming_thread: the port compiles nothing per
    # measure, so the first frame starts no thread, and a measure switch
    # renders the new measure at once.
    pair = AppPair(*scenes())
    before = set(threading.enumerate())
    pair.port.frame_png()
    pair.api({"op": "set_measure", "measure": "mi_kraskov"})
    assert set(threading.enumerate()) <= before
    assert not hasattr(pair.port, "_warm_thread")
    pair.jax.frame_png()  # JAX's first frame, as in the session above
    pair.frame()
    assert set(threading.enumerate()) <= before


@case
def export_similarity_tfopt_ops(tmp_path):
    pair = AppPair(*scenes())
    pair.frame()  # the derived field computed
    paths = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    want = pair.jax.api({"op": "export_field", "path": paths[0]})
    got = pair.port.api({"op": "export_field", "path": paths[1]})
    assert got["ok"] and got["field"].startswith("Pearson")
    assert got == {**want, "path": paths[1]}
    fields = [load_volume(p, device="cpu") for p in paths]
    np.testing.assert_allclose(
        fields[1].get_field(fields[1].field_names[0]).numpy(),
        fields[0].get_field(fields[0].field_names[0]).numpy(), atol=2e-5)
    s = pair.api({"op": "similarity", "field_a": "data", "field_b": "data"})
    assert s["ok"] and s["value"] == pytest.approx(1.0, abs=1e-5)
    o = pair.api({"op": "tf_optimize", "field_src": "data",
                  "field_dst": "data", "tf_size": 16})
    assert o["ok"]
    np.testing.assert_allclose(
        pair.port.scene.transfer_functions["data"].lut.numpy(),
        np.asarray(pair.jax.scene.transfer_functions["data"].lut),
        atol=1e-4)
    pair.frame()
    bad = pair.api({"op": "tf_optimize", "field_src": "data",
                    "field_dst": "data", "tf_size": 7})
    assert not bad["ok"]


@case
def set_view_multi_view(tmp_path):
    pair = AppPair(*scenes(cameras=((0.0, 0.2, 0.8), (0.6, 0.1, 0.4))))
    assert pair.api({"op": "info"})["num_views"] == 2
    p0 = pair.frame()
    assert pair.api({"op": "set_view", "view": 1})["ok"]
    assert pair.frame() != p0  # the other camera
    assert not pair.api({"op": "set_view", "view": 5})["ok"]


@case
def heb_drilldown_ops(tmp_path):
    pair = AppPair(*scenes())
    base_png = pair.frame()
    r = pair.api({"op": "heb_chords", "downsample": 4, "num_samples": 6})
    assert r["ok"] and r["depth"] == 1 and r["chords"]
    assert {"index", "value", "a", "b"} <= set(r["chords"][0])
    d = pair.api({"op": "heb_drill", "chord": 0, "downsample": 4,
                  "num_samples": 6})
    assert d["ok"] and d["depth"] == 2
    assert pair.frame() != base_png  # the outlines
    assert "<svg" in pair.diagram("heb", {"downsample": 4,
                                          "num_samples": 6})
    assert "<svg" in pair.diagram("heb", {"downsample": 4, "num_samples": 6,
                                          "context": "1"})
    assert not pair.api({"op": "heb_drill", "chord": 9999, "downsample": 4,
                         "num_samples": 6})["ok"]
    p = pair.api({"op": "heb_pop"})
    assert p["ok"] and p["depth"] == 1
    pair.api({"op": "set_measure", "measure": "spearman"})
    assert "<svg" in pair.diagram("heb", {"downsample": 4, "num_samples": 6,
                                          "measure": "spearman"})
    rst = pair.api({"op": "heb_reset"})
    assert rst["ok"] and rst["depth"] == 0
    assert pair.api({"op": "heb_pop"})["ok"] is False


@case
def heavy_diagrams_serve_off_lock(tmp_path):
    pair = AppPair(*scenes())
    pair.frame()
    done = {}

    def diag():
        done["svg"] = pair.port.diagram_svg(
            "heb", {"downsample": 2, "num_samples": 8})

    t = threading.Thread(target=diag)
    t.start()
    pair.port.api({"op": "orbit", "dtheta": 0.3})
    pair.port.frame_png()  # not serialized behind the chart
    t.join(timeout=120)
    pair.jax.api({"op": "orbit", "dtheta": 0.3})
    want = pair.jax.diagram_svg("heb", {"downsample": 2, "num_samples": 8})
    assert_svgs_alike(done["svg"], want, "heb")
    pair.frame()
    assert "<svg" in pair.diagram("heb", {"downsample": 2, "num_samples": 8,
                                          "sampling_method": "mean"})
    assert "<svg" in pair.diagram("distribution", {"max_points": 60})


@case
def plain_diagram_defaults_serve_the_drill_stack(tmp_path):
    pair = AppPair(*scenes())
    r = pair.api({"op": "heb_chords"})
    assert r["ok"] and r["chords"]
    with pair.port._lock:
        field, measure, _ = pair.port._diagram_field_measure({})
        expected = pair.port._heb_key({}, field, measure,
                                      pair.port.scene.current_time)
    assert pair.port._drilldown_key == expected == pair.jax._drilldown_key


@case
def stale_drill_outlines_leave_the_frame(tmp_path):
    pair = AppPair(*scenes())
    pair.api({"op": "heb_chords", "num_samples": 4,
              "sampling_method": "mean"})
    d = pair.api({"op": "heb_drill", "chord": 0, "num_samples": 4,
                  "sampling_method": "mean"})
    assert d["ok"] and d["depth"] == 2
    with_overlay = pair.frame()
    pair.api({"op": "set_measure", "measure": "spearman"})
    stale = pair.frame()  # the drill stack is set, but stale
    pair.api({"op": "heb_reset"})
    cleared = pair.frame()
    assert stale == cleared and with_overlay != cleared


@case
def all_nan_cells_report_cleanly(tmp_path):
    pair = AppPair(*_series_scene(ts=6, seed=5, nan=True, correlated=False))
    message = raise_alike(
        lambda: pair.jax.diagram_svg("timeseries", {"downsample": 8}),
        lambda: pair.port.diagram_svg("timeseries", {"downsample": 8}))
    assert "finite" in message
    pair.close()


@case
def timeseries_runs_as_heavy_job_off_lock(tmp_path):
    pair = AppPair(*_series_scene(ts=6, seed=5, correlated=False))
    job = pair.port._heavy_diagram_job("timeseries", {"downsample": 4})
    assert job is not None
    want = pair.jax._heavy_diagram_job("timeseries", {"downsample": 4})()
    assert_svgs_alike(job(), want, "timeseries")
    pair.close()


@case
def set_color_points_changes_tf(tmp_path):
    with http_pair() as pair:
        target = pair.port._tf_targets()[0]
        lut_before = pair.port.scene.tf_for(target).lut.clone()
        reply = pair.api({"op": "set_tf", "color_points": [
            [0.0, [0.0, 0.0, 1.0]], [1.0, [1.0, 1.0, 0.0]]]})
        assert reply.get("ok", True)
        lut_after = pair.port.scene.tf_for(target).lut
        assert float((lut_after[:, :3] - lut_before[:, :3]).abs().max()) > 0.1
        np.testing.assert_allclose(
            lut_after.numpy(),
            np.asarray(pair.jax.scene.tf_for(target).lut), atol=1e-6)
        info = pair.api({"op": "info"})
        assert info["color_points"][0] == [0.0, [0.0, 0.0, 1.0]]
        pair.frame()
        pair.api({"op": "set_tf", "color_points": None})
        assert pair.api({"op": "info"})["color_points"] is None


@case
def color_points_validation(tmp_path):
    with http_pair() as pair:
        for cpts in ([[0.0, [0.0, 0.0]]],
                     [[0.5, [0, 0, 0]]],
                     [[0.9, [0, 0, 0]], [0.1, [1, 1, 1]]],
                     [[0.0, [2, 0, 0]], [1.0, [0, 0, 0]]]):
            reply = pair.api({"op": "set_tf", "color_points": cpts})
            assert reply["ok"] is False, cpts


@case
def tf_save_load_roundtrip(tmp_path):
    with http_pair() as pair:
        cpts = [[0.0, [0.1, 0.2, 0.3]], [0.5, [0.9, 0.9, 0.1]],
                [1.0, [0.2, 0.8, 0.4]]]
        pair.api({"op": "set_tf", "color_points": cpts,
                  "opacity_points": [[0.0, 0.1], [1.0, 0.9]]})
        path = str(tmp_path / "tf.xml")
        got = pair.port.api({"op": "tf_save", "path": path})
        want = pair.jax.api({"op": "tf_save",
                             "path": str(tmp_path / "jax_tf.xml")})
        assert got["ok"] and "<TransferFunction" in got["xml"]
        assert got["xml"] == want["xml"]
        xml_saved = open(path).read()
        pair.api({"op": "set_tf", "color_points": None,
                  "opacity_points": None})
        assert pair.api({"op": "tf_load", "path": path}).get("ok", True)
        got = pair.api({"op": "info"})["color_points"]
        assert len(got) == 3
        for (p_want, c_want), (p_got, c_got) in zip(cpts, got):
            assert abs(p_want - p_got) < 1e-6
            assert max(abs(a - b) for a, b in zip(c_want, c_got)) \
                < 1.0 / 65535 + 1e-6  # ushort quantization
        pair.frame()
        path2 = str(tmp_path / "tf2.xml")
        pair.port.api({"op": "tf_save", "path": path2})
        assert open(path2).read() == xml_saved


@case
def tf_load_rejects_garbage(tmp_path):
    with http_pair() as pair:
        assert pair.api({"op": "tf_load", "xml": "<NotATF/>"})["ok"] is False
        assert pair.api({"op": "tf_load"})["ok"] is False


@case
def timing_op_reports_frame_split(tmp_path):
    pair = AppPair(*scenes(), image_size=(96, 72))
    pair.frame()
    t = pair.api({"op": "timing"})
    assert t["ok"]
    for k in TIMING_KEYS:
        assert t[k] >= 0.0
    assert t["total_ms"] >= t["render_ms"] > 0.0


@case
def continuous_recompute_forces_frame_recompute(tmp_path):
    # tests/test_aux.py's viewer case.
    data = box_data(members=10)
    js, ts = scenes({"data": lambda t, e: data[e]},
                    grid=dict(xs=16, ys=16, zs=8, es=10))
    for sc in (js, ts):
        next(iter(sc.volume_data.calculators.values())).reference_point = \
            (1, 1, 1)
    pair = AppPair(js, ts)
    f1 = pair.frame()
    assert pair.port.frame_png() is f1  # cached while nothing is dirty
    vd = ts.volume_data
    calc = port_calc(pair.port)
    epoch_before = vd.dirty_epoch(calc.output_name)
    assert pair.api({"op": "set_option", "key": "continuous_recompute",
                     "value": True}).get("ok", True)
    assert calc.continuous_recompute is True
    pair.frame()
    pair.frame()
    assert vd.dirty_epoch(calc.output_name) >= epoch_before + 2
    pair.api({"op": "set_option", "key": "continuous_recompute",
              "value": False})
    g1 = pair.frame()
    assert pair.port.frame_png() is g1  # the cache is back


def _netcdf(tmp_path):
    data = jfixtures.synth_box_ensemble(xs=8, ys=8, zs=4, members=6)
    nc = str(tmp_path / "ens.nc")
    jax_writers.write_netcdf(nc, data[:, None])
    return nc


@case
def view_accepts_state_file(tmp_path):
    # tests/test_state_ref.py's `cli view --state` case, serve() replaced.
    nc = _netcdf(tmp_path)
    state = tmp_path / "state.json"
    state.write_text(json.dumps({
        "renderers": [{"type": "dvr", "state": {"selected_field_idx": "0"}}],
        "volume_data": {"filename": nc},
    }))
    served = {}
    mp = pytest.MonkeyPatch()
    try:
        for mod, key in ((jax_viewer, "jax"), (viewer, "port")):
            mp.setattr(mod, "serve",
                       lambda scene, _k=key, **kw: served.update(
                           {_k: (scene, kw)}))
        jax_cli.main(["view", "--state", str(state), "--size", "64x48"])
        cli.main(["view", "--state", str(state), "--size", "64x48",
                  "--device", "cpu"])
    finally:
        mp.undo()
    (jscene, jkw), (scene, kw) = served["jax"], served["port"]
    assert scene.renderers[0]["type"] == "dvr"
    assert scene.renderers == jscene.renderers
    assert kw == jkw == {"host": "127.0.0.1", "port": 8777,
                         "image_size": (64, 48), "fast_dvr": True}
    assert scene.volume_data.device.type == "cpu"
    pair = AppPair(jscene, scene)
    pair.frame()


@case
def view_without_dataset_or_state_errors(tmp_path):
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit, match="--dataset or --state"):
            main(["view"])


@case
def view_builds_a_dataset_scene(tmp_path):
    # `view --dataset` builds render's scene; serve() replaced.
    nc = _netcdf(tmp_path)
    served = {}
    mp = pytest.MonkeyPatch()
    argv = ["view", "--dataset", nc, "--measure", "spearman", "--ref",
            "2,2,2", "--size", "64x48", "--port", "0", "--exact-dvr"]
    try:
        for mod, key in ((jax_viewer, "jax"), (viewer, "port")):
            mp.setattr(mod, "serve",
                       lambda scene, _k=key, **kw: served.update(
                           {_k: (scene, kw)}))
        jax_cli.main(argv)
        cli.main(argv + ["--device", "cpu"])
    finally:
        mp.undo()
    (jscene, jkw), (scene, kw) = served["jax"], served["port"]
    assert kw == jkw and kw["fast_dvr"] is False and kw["port"] == 0
    pair = AppPair(jscene, scene)
    pair.api({"op": "set_option", "key": "fast_dvr", "value": True})
    pair.frame()


@case
def diagram_node_overrides_heb_defaults(tmp_path):
    # tests/test_state_ref.py's TestViewerHebDefaults, both packages.
    data = box_data(members=12)
    doc = {"renderers": [
        {"type": "dvr", "state": {"selected_field_idx": "0"}},
        {"type": "diagram", "state": {
            "correlation_measure_type": "pearson",
            "downscaling_factor_x": "8", "downscaling_factor_y": "8",
            "downscaling_factor_z": "4", "sampling_method_type": "Mean",
            "num_samples": "12", "line_count_factor_context": "99",
            "correlation_range_lower": "0.25",
            "correlation_range_upper": "1",
        }},
    ]}
    p = tmp_path / "s.json"
    p.write_text(json.dumps(doc))
    js, ts = scenes({"data": lambda t, e: data[e]},
                    grid=dict(xs=16, ys=16, zs=8, es=12), calculator=False,
                    renderer=False)
    jscene = JaxScene.load_state(str(p), volume_data=js.volume_data)
    scene = Scene.load_state(str(p), volume_data=ts.volume_data)
    pair = AppPair(jscene, scene)
    d = pair.port._heb_defaults()
    assert d == pair.jax._heb_defaults()
    assert d["downsample"] == (8, 8, 4) and d["sampling_method"] == "mean"
    assert d["num_samples"] == 12 and d["max_chords"] == 99
    assert d["correlation_range"] == (0.25, 1.0)
    key = pair.port._heb_key({}, "data", "pearson", 0)
    assert key == pair.jax._heb_key({}, "data", "pearson", 0)
    assert key[3] == (8, 8, 4) and key[5] == "mean"
    info = pair.api({"op": "info"})
    assert info["heb_defaults"]["downsample"] == [8, 8, 4]
    assert pair.port._heb_key({"downsample": "4"}, "data", "pearson",
                              0)[3] == 4


@case
def exact_quality_frame(tmp_path):
    # fast_dvr off: the Scene's exact DVR (B5 on the card), in a view
    # closer than the default so JAX's marcher takes it (tests/
    # test_torch_port_scene.py).
    pair = AppPair(*scenes(cameras=((0.0, 0.1, 0.55),)))
    assert pair.api({"op": "set_option", "key": "fast_dvr",
                     "value": False})["ok"]
    assert pair.port._fused_dvr_job() is None
    pair.frame()
    pair.api({"op": "pick", "px": 32, "py": 24})
    pair.frame()


@pytest.mark.parametrize("name", sorted(CASES))
def test_viewer_case_matches_jax(name, tmp_path):
    CASES[name](tmp_path)


@pytest.mark.parametrize("measure", MEASURES)
def test_measure_switch_matches_jax(measure):
    """``set_measure`` over HTTP for each measure id: the reply, the
    renamed field and the fused frame of the new measure."""
    with http_pair() as pair:
        pair.frame()
        reply = pair.api({"op": "set_measure", "measure": measure})
        assert reply["ok"]
        calc = port_calc(pair.port)
        assert calc.measure.value == measure
        assert pair.port._fused_dvr_job() is not None
        pair.frame()
        info = pair.api({"op": "info"})
        assert info["measure"] == measure
        assert info["derived_fields"] == [calc.output_name]


@pytest.mark.parametrize("renderer", viewer.ViewerApp._VOLUME_RENDERERS)
def test_renderer_switch_matches_jax(renderer):
    """``set_renderer`` over HTTP for each volume renderer, with its
    options."""
    options = {"dvr": [("attenuation", 40.0)],
               "iso_ray": [("iso_value", 0.4)],
               "iso_raster": [("iso_value", 0.4)],
               "slice": [("axis", "x"), ("position", 0.3)]}[renderer]
    with http_pair() as pair:
        assert pair.api({"op": "set_renderer", "renderer": renderer})["ok"]
        pair.frame()
        for key, value in options:
            assert pair.api({"op": "set_renderer_option", "key": key,
                             "value": value})["ok"]
        assert pair.port.scene.renderers[0][options[-1][0]] == \
            options[-1][1]
        pair.frame()


#: Each mutating op with a valid command; the frame after it must be
#: rendered anew (a missed epoch bump would serve the cached PNG).
MUTATIONS = {
    "orbit": {"op": "orbit", "dtheta": 0.4, "dphi": -0.2},
    "zoom": {"op": "zoom", "factor": 0.8},
    "pick": {"op": "pick", "px": 30, "py": 20},
    "set_measure": {"op": "set_measure", "measure": "spearman"},
    "set_field": {"op": "set_field", "field": "data"},
    "set_colormap": {"op": "set_colormap", "colormap": "heatmap"},
    "set_tf": {"op": "set_tf", "opacity_points": [[0, 0.5], [1, 0.2]]},
    "tf_load": {"op": "tf_load", "xml": None},  # the saved XML, below
    "set_absolute": {"op": "set_absolute", "value": True},
    "set_renderer": {"op": "set_renderer", "renderer": "slice"},
    "set_renderer_option": {"op": "set_renderer_option",
                            "key": "attenuation", "value": 30.0},
    "set_view": {"op": "set_view", "view": 0},
    "set_time": {"op": "set_time", "time": 0},
    "set_member": {"op": "set_member", "member": 3},
    "set_option": {"op": "set_option", "key": "legend", "value": False},
    "checkpoint_restore": {"op": "checkpoint_restore", "name": "home"},
    "tf_optimize": {"op": "tf_optimize", "field_src": "data",
                    "field_dst": "data", "tf_size": 16},
    "heb_drill": {"op": "heb_drill", "chord": 0, "downsample": 4,
                  "num_samples": 4, "sampling_method": "mean"},
    "heb_reset": {"op": "heb_reset"},
}


@pytest.mark.parametrize("op", list(MUTATIONS))
def test_every_mutating_op_renders_anew(op):
    pair = AppPair(*scenes())
    pair.api({"op": "checkpoint_save", "name": "home"})
    cmd = dict(MUTATIONS[op])
    if op == "tf_load":
        cmd["xml"] = pair.port.api({"op": "tf_save"})["xml"]
    if op == "pick":
        pair.api({"op": "zoom", "factor": 0.7})
    before = pair.frame()
    assert pair.port.frame_png() is before
    assert pair.api(cmd)["ok"]
    after = pair.frame()
    assert after is not before
    assert pair.port.last_frame_timing["total_ms"] > 0.0


class JaxClient:
    """JAX's viewer server with ``chip_smoke.ViewerClient``'s interface."""

    def __init__(self, scene, image_size):
        self.server, self.app = jax_viewer.make_server(
            scene, port=0, image_size=image_size, warm_measures=False)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = "http://%s:%d" % self.server.server_address

    def request(self, path, cmd=None, ctype="application/json"):
        req = self.base + path
        if cmd is not None:
            req = urllib.request.Request(
                req, data=json.dumps(cmd).encode(), method="POST",
                headers={"Content-Type": ctype})
        return _request(req)

    def api(self, cmd):
        status, _, body, _ = self.request("/api", cmd)
        assert status == 200
        return json.loads(body)

    def image(self):
        status, _, body, _ = self.request("/frame")
        assert status == 200
        return decode(body)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        self.app.close()


def test_scripted_session_matches_jax(tmp_path):
    """The session ``chip_smoke.py`` phase 29 (a) sends to the card's and
    the CPU's servers (``viewer_steps``: every op, its guards and errors,
    the diagrams, the drill-down, state, export, similarity, a TF fit,
    each measure and renderer), here to JAX's server and the port's over
    loopback, held by the same ``viewer_session``."""
    import chip_smoke

    a, b = box_data(), box_data(seed=7)
    js, ts = scenes({"q": lambda t, e: a[e], "r": lambda t, e: b[e]},
                    cameras=((0.05, 0.3, 0.85),))  # config 1's camera
    clients = [chip_smoke.ViewerClient(ts, chip_smoke.VIEWER_TESTS_IMAGE),
               JaxClient(js, chip_smoke.VIEWER_TESTS_IMAGE)]
    dirs = [str(tmp_path / d) for d in ("port", "jax")]
    for d in dirs:
        (tmp_path / d).mkdir()
    try:
        stats = chip_smoke.viewer_session(
            "CPU", "port against JAX", clients, dirs,
            chip_smoke.viewer_steps(chip_smoke.VIEWER_TESTS_IMAGE, 4,
                                    MEASURES))
    finally:
        for c in clients:
            c.close()
    assert stats["frames"] >= 25 and stats["ops"] >= 70


def test_cached_frame_reports_zero_server_ms():
    """ADVICE #3 not copied: a frame served from the cache reports
    ``X-Server-Frame-Ms: 0.0`` and a zeroed ``timing`` op; JAX's reports
    the previous frame's cost."""
    with http_pair() as pair:
        pair.frame()
        first = [float(h["X-Server-Frame-Ms"]) for h in pair.headers]
        assert min(first) > 0.0
        pair.frame()
        jax_h, port_h = pair.headers
        assert port_h["X-Server-Frame-Ms"] == "0.0"
        assert float(jax_h["X-Server-Frame-Ms"]) == first[0]
        timing = pair.port.api({"op": "timing"})
        assert all(timing[k] == 0.0 for k in TIMING_KEYS)
        pair.api({"op": "orbit", "dtheta": 0.1})
        pair.frame()
        assert float(pair.headers[1]["X-Server-Frame-Ms"]) > 0.0


def test_render_error_is_a_500_with_json():
    """A failing render reaches the client as JAX's does: a 500 with the
    error as JSON."""
    with http_pair() as pair:
        for sc in (pair.jax.scene, pair.port.scene):
            sc.renderers[0]["field"] = "missing"
            sc.renderers[0]["type"] = "slice"
        (status, ctype, body), (_, _, jbody) = pair.get("/frame")
        assert status == 500 and ctype == "application/json"
        assert json.loads(body).keys() == json.loads(jbody).keys() == {
            "error"}


def test_serve_returns_after_closing():
    """``serve`` ends on ctrl-C: it closes the server and returns."""
    _, scene = scenes()
    calls = []

    class Stop(viewer._Server):
        def serve_forever(self, poll_interval=0.5):
            calls.append("serve")
            raise KeyboardInterrupt

        def server_close(self):
            calls.append("close")
            super().server_close()

    mp = pytest.MonkeyPatch()
    mp.setattr(viewer, "_Server", Stop)
    try:
        assert viewer.serve(scene, port=0) is None
    finally:
        mp.undo()
    assert calls == ["serve", "close"]
