"""PyTorch port (correrender_tpu_torch.models) vs the JAX package's
neural models: encodings (with the hash grid's indices), the MLP, the
symmetrizers, the SRN, the Adam trainers, checkpoints and the
TorchScript import.

Both packages run on the same seeded numpy inputs and the same
parameters: JAX's pytrees reach the port through
``interop.srn_params_from_jax`` (or the port's reach JAX as numpy), on
the CPU. Training is held step for step: the JAX side is composed from
its own ``model.apply``, ``jax.value_and_grad`` and
``models.mine._adam_update`` over the batch indices (and MINE's
permutations) that the port's trainers draw from their generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correrender_tpu.models import checkpoint as jax_checkpoint
from correrender_tpu.models import encodings as jax_enc
from correrender_tpu.models import mine as jax_mine
from correrender_tpu.models import symmetrizer as jax_sym
from correrender_tpu.models import vmlp as jax_vmlp
from correrender_tpu.models.torch_import import (
    srn_from_torch_archive as jax_srn_from_torch_archive,
)

from correrender_tpu_torch.interop import srn_params_from_jax
from correrender_tpu_torch.models import checkpoint, encodings, mine
from correrender_tpu_torch.models import symmetrizer, vmlp
from correrender_tpu_torch.models.torch_import import srn_from_torch_archive
from correrender_tpu_torch.models.tree import tree_map

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*torch\\.jit\\.script.*:DeprecationWarning")

# Bars: features within 1e-6 (float32 sin/cos and trilinear weights,
# a few ulps apart between XLA and torch), MLP and SRN forwards within
# 2e-5 (float32 products of another summation order), bfloat16 compute
# within 1e-2 relative (a bf16 rounding of a hidden activation may fall
# on the other side), parameters after 20 paired Adam steps within 1e-4.
ATOL_FEATURES = 1e-6
ATOL_FORWARD = 2e-5
RTOL_BF16 = 1e-2
ATOL_TRAINED = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def to_numpy(tree):
    return tree_map(lambda a: np.asarray(a), tree)


def port_params(jax_params):
    return srn_params_from_jax(to_numpy(jax_params))


def jax_params_of(port):
    return tree_map(lambda t: jnp.asarray(t.numpy()), port)


def positions(n, seed=0):
    """Uniform positions in [0, 1]^3 with the cube's corners among them
    (the grid's clipped edges)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)).astype(np.float32)
    x[:8] = [[(m >> d) & 1 for d in range(3)] for m in range(8)]
    return x


def flat(tree, prefix=""):
    """{key path: numpy array} of a parameter tree (dict keys in their
    own order: ``jax.tree.leaves`` sorts them)."""
    if isinstance(tree, dict):
        return {k: a for key, v in tree.items()
                for k, a in flat(v, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: a for i, v in enumerate(tree)
                for k, a in flat(v, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): np.asarray(tree)}


def assert_trees_close(got, want, atol):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        assert g.shape == want[key].shape, key
        np.testing.assert_allclose(g, want[key], rtol=0, atol=atol,
                                   err_msg=key)


def shapes(tree):
    return {k: a.shape for k, a in flat(tree).items()}


# -- encodings -----------------------------------------------------------

@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("hash_type",
                         ["prime", "coherent_prime", "reversed_prime"])
@pytest.mark.parametrize("grid_type", ["hash", "dense"])
def test_hash_indices_equal_jax(grid_type, hash_type, dims):
    kw = dict(dims=dims, num_levels=6, log2_hashmap_size=10,
              base_resolution=7, per_level_scale=2.0, grid_type=grid_type,
              hash_type=hash_type)
    jenc, tenc = jax_enc.HashGridEncoding(**kw), encodings.HashGridEncoding(
        **kw)
    rng = np.random.default_rng(dims)
    hashed = 0
    for lvl in range(kw["num_levels"]):
        res, size = jenc._level_resolution(lvl), jenc._table_size(lvl)
        corner = rng.integers(0, res, (4096, dims)).astype(np.int32)
        corner[0] = res - 1
        want = np.asarray(jenc._index(jnp.asarray(corner), res, size))
        got = tenc._index(torch.from_numpy(corner), res, size).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < size
        hashed += res**dims > size
    # The hash grid's coarse levels index densely, its fine ones hash.
    if grid_type == "dense":
        assert hashed == 0
    else:
        assert 0 < hashed < kw["num_levels"]


ENCODINGS = {
    "identity": lambda m: m.IdentityEncoding(3),
    "frequency4": lambda m: m.FrequencyEncoding(dims=3, num_frequencies=4),
    "frequency6": lambda m: m.FrequencyEncoding(dims=3, num_frequencies=6),
    "hash_linear": lambda m: m.HashGridEncoding(
        num_levels=5, base_resolution=4, log2_hashmap_size=9),
    "hash_nearest": lambda m: m.HashGridEncoding(
        num_levels=5, base_resolution=4, log2_hashmap_size=9,
        interpolation="nearest"),
    "dense_linear": lambda m: m.HashGridEncoding(
        num_levels=3, base_resolution=3, grid_type="dense"),
    "coherent_linear": lambda m: m.HashGridEncoding(
        num_levels=4, base_resolution=5, log2_hashmap_size=8,
        hash_type="coherent_prime", features_per_level=3),
    "composite": lambda m: m.CompositeEncoding(
        encodings=(m.FrequencyEncoding(dims=2, num_frequencies=3),
                   m.HashGridEncoding(dims=1, num_levels=3,
                                      base_resolution=4)),
        slices=((0, 2), (2, 3))),
}


@pytest.mark.parametrize("kind", sorted(ENCODINGS))
def test_encoding_features_match_jax(kind):
    jenc, tenc = ENCODINGS[kind](jax_enc), ENCODINGS[kind](encodings)
    assert tenc.num_features == jenc.num_features
    params = jenc.init(jax.random.key(3))
    x = positions(500)
    want = np.asarray(jenc.apply(params, jnp.asarray(x)))
    got = tenc(port_params(params), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (500, jenc.num_features)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FEATURES)


def test_frequency_feature_order_is_sines_then_cosines_per_axis():
    x = np.asarray([[0.1, 0.2, 0.3]], np.float32)
    got = encodings.FrequencyEncoding(3, 2)({}, torch.from_numpy(x))[0]
    freqs = np.float32(np.pi) * np.asarray([1, 2], np.float32)
    want = np.concatenate([np.concatenate([np.sin(v * freqs),
                                           np.cos(v * freqs)])
                           for v in x[0]])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_dictionary_encoding_matches_jax():
    jenc = jax_enc.DictionaryEncoding(num_embeddings=10, features=4)
    tenc = encodings.DictionaryEncoding(num_embeddings=10, features=4)
    params = jenc.init(jax.random.key(0))
    idx = np.asarray([0, 3.7, 9, 2], np.float32)
    want = np.asarray(jenc.apply(params, jnp.asarray(idx)))
    got = tenc(port_params(params), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_init_shapes_match_jax():
    for kind in sorted(ENCODINGS):
        jp = ENCODINGS[kind](jax_enc).init(jax.random.key(0))
        tp = ENCODINGS[kind](encodings).init(torch.Generator().manual_seed(0))
        assert shapes(tp) == shapes(jp)
    grid = encodings.HashGridEncoding(num_levels=3)
    tables = grid.init(torch.Generator().manual_seed(0))["tables"]
    assert all(float(t.abs().max()) <= 1e-4 for t in tables)


# -- MLP and symmetrizers --------------------------------------------------

@pytest.mark.parametrize("act", ["none", "relu", "snake", "snake_alt"])
def test_mlp_matches_jax(act):
    kw = dict(in_features=12, hidden=32, out_features=3, num_layers=3,
              activation=act)
    jm, tm = jax_vmlp.MLP(**kw), vmlp.MLP(**kw)
    params = jm.init(jax.random.key(1))
    x = np.random.default_rng(1).normal(size=(300, 12)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(port_params(params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FORWARD)


def test_mlp_bfloat16_compute_matches_jax():
    kw = dict(in_features=8, hidden=32, out_features=2, num_layers=3,
              compute_dtype="bfloat16")
    jm, tm = jax_vmlp.MLP(**kw), vmlp.MLP(**kw)
    params = jm.init(jax.random.key(2))
    x = np.random.default_rng(2).normal(size=(400, 8)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(port_params(params), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_BF16,
                               atol=RTOL_BF16 * np.abs(want).max())
    # The float32 result differs from the bf16 one by more than the bar
    # would hide: the rounding is really applied.
    f32 = vmlp.MLP(**{**kw, "compute_dtype": "float32"})(
        port_params(params), torch.from_numpy(x))
    assert float((f32 - got).abs().max()) > 1e-4


def test_stacked_mlp_is_each_network():
    tm = vmlp.MLP(2, hidden=8, out_features=1, num_layers=2)
    gen = torch.Generator().manual_seed(0)
    nets = [tm.init(gen) for _ in range(3)]
    stacked = tree_map(lambda *ls: torch.stack(ls), *nets)
    x = torch.randn(3, 10, 2, generator=gen)
    got = tm(stacked, x)
    for p in range(3):
        torch.testing.assert_close(got[p], tm(nets[p], x[p]), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["add", "add_diff", "mul"])
def test_symmetrizers_equal_jax(kind):
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_sym.symmetrize(jnp.asarray(a), jnp.asarray(b),
                                         kind))
    got = symmetrizer.symmetrize(torch.from_numpy(a), torch.from_numpy(b),
                                 kind).numpy()
    np.testing.assert_array_equal(got, want)
    assert symmetrizer.symmetrizer_output_features(5, kind) == \
        jax_sym.symmetrizer_output_features(5, kind) == got.shape[-1]


# -- the SRN ---------------------------------------------------------------

SRN_CONFIGS = {
    "frequency_add_diff": dict(hidden=32, latent=16, num_frequencies=4),
    "frequency_add": dict(hidden=16, latent=8, num_frequencies=3,
                          symmetrizer="add"),
    "frequency_mul": dict(hidden=16, latent=8, num_frequencies=2,
                          symmetrizer="mul"),
    "hash_grid": dict(hidden=32, latent=16, encoding="hash_grid",
                      hash_levels=4, hash_log2_size=10, hash_base_res=4,
                      hash_per_level_scale=1.6),
}


@pytest.mark.parametrize("name", sorted(SRN_CONFIGS))
def test_srn_forward_matches_jax(name):
    jm = jax_mine.CorrelationSRN.create(**SRN_CONFIGS[name])
    tm = mine.CorrelationSRN.create(**SRN_CONFIGS[name])
    params = jm.init(jax.random.key(5))
    pr, pq = positions(400, 1), positions(400, 2)
    want = np.asarray(jm.apply(params, jnp.asarray(pr), jnp.asarray(pq)))
    tp = port_params(params)
    got = tm(tp, torch.from_numpy(pr), torch.from_numpy(pq)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FORWARD)
    # A reference encoded once and broadcast gives the same field.
    ea = tm.encode(tp, torch.from_numpy(pr[:1]))
    eb = tm.encode(tp, torch.from_numpy(pq))
    np.testing.assert_allclose(tm.decode(tp, ea, eb).numpy(),
                               np.asarray(jm.apply(
                                   params, jnp.broadcast_to(pr[:1], pq.shape),
                                   jnp.asarray(pq))),
                               rtol=0, atol=ATOL_FORWARD)


@pytest.mark.parametrize("name", sorted(SRN_CONFIGS))
def test_config_array_round_trips_both_ways(name):
    jm = jax_mine.CorrelationSRN.create(**SRN_CONFIGS[name])
    tm = mine.CorrelationSRN.create(**SRN_CONFIGS[name])
    np.testing.assert_array_equal(tm.config_array(), jm.config_array())
    back_t = mine.CorrelationSRN.from_config_array(jm.config_array())
    back_j = jax_mine.CorrelationSRN.from_config_array(tm.config_array())
    np.testing.assert_array_equal(back_t.config_array(), jm.config_array())
    np.testing.assert_array_equal(back_j.config_array(), tm.config_array())
    params = jm.init(jax.random.key(0))
    assert shapes(back_t.init(torch.Generator())) == shapes(params)


def test_legacy_config_arrays_decode_as_jax():
    cfg = jax_mine.CorrelationSRN.create(
        hidden=16, latent=8, encoding="hash_grid", hash_levels=4,
        hash_log2_size=10, hash_base_res=3,
        hash_per_level_scale=1.60049).config_array()
    legacy = np.array(cfg, copy=True)
    legacy[12] = 1600  # the ×1000 form
    freq = jax_mine.CorrelationSRN.create(hidden=16, latent=8)
    for c in (cfg, legacy, freq.config_array()[:7],
              freq.config_array()[:4]):
        j = jax_mine.CorrelationSRN.from_config_array(c)
        t = mine.CorrelationSRN.from_config_array(c)
        np.testing.assert_array_equal(t.config_array(), j.config_array())
    assert mine.CorrelationSRN.from_config_array(
        cfg).encoding.per_level_scale == 1.60049


# -- checkpoints and the TorchScript import -------------------------------

@pytest.mark.parametrize("name", ["frequency_add_diff", "hash_grid"])
def test_npz_presets_interchange_both_ways(tmp_path, name):
    jm = jax_mine.CorrelationSRN.create(**SRN_CONFIGS[name])
    tm = mine.CorrelationSRN.create(**SRN_CONFIGS[name])
    # Saved by JAX, loaded by the port.
    jp = jm.init(jax.random.key(7))
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_params(path, {"config": jm.config_array(),
                                      "params": jp})
    template = {"config": tm.config_array(),
                "params": tm.init(torch.Generator())}
    got = checkpoint.load_params(path, template)
    assert_trees_close(got["params"], jp, 0.0)
    np.testing.assert_array_equal(got["config"].numpy(), jm.config_array())
    # Saved by the port, loaded by JAX.
    tp = tm.init(torch.Generator().manual_seed(8))
    path = str(tmp_path / "port.npz")
    checkpoint.save_params(path, {"config": tm.config_array(),
                                  "params": tp})
    back = jax_checkpoint.load_params(path, {"config": jm.config_array(),
                                             "params": jp})
    assert_trees_close(tp, back["params"], 0.0)
    with np.load(path) as a, np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files)


def test_load_params_missing_key_raises(tmp_path):
    path = str(tmp_path / "p.npz")
    checkpoint.save_params(path, {"a": torch.ones(3)})
    with pytest.raises(KeyError, match="'b'"):
        checkpoint.load_params(path, {"a": torch.ones(3), "b": torch.ones(2)})


def make_srn_archive(tmp_path, sym_width=2, latent=8):
    """An encoder/decoder pair shaped like the reference's SRN nets,
    saved by ``torch.jit.script`` (tests/test_torch_import.py's)."""
    nn = torch.nn

    class SRN(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = nn.Sequential(
                nn.Linear(36, 16), nn.ReLU(), nn.Linear(16, latent))
            self.decoder = nn.Sequential(
                nn.Linear(latent * sym_width, 16), nn.ReLU(),
                nn.Linear(16, 1))

        def forward(self, a, b):
            ea, eb = self.encoder(a), self.encoder(b)
            if eb.shape[-1] * 2 == self.decoder[0].in_features:
                z = torch.cat([ea + eb, torch.abs(ea - eb)], dim=-1)
            else:
                z = ea + eb
            return self.decoder(z)

    torch.manual_seed(sym_width)
    m = SRN().eval()
    path = str(tmp_path / "srn.pt")
    torch.jit.script(m).save(path)
    return m, path


@pytest.mark.parametrize("sym_width", [1, 2])
def test_torchscript_import_equals_jax_mapping(tmp_path, sym_width):
    module, path = make_srn_archive(tmp_path, sym_width)
    jm, jp = jax_srn_from_torch_archive(path)
    tm, tp = srn_from_torch_archive(path)
    assert tm.symmetrizer == jm.symmetrizer == (
        "add_diff" if sym_width == 2 else "add")
    np.testing.assert_array_equal(tm.config_array(), jm.config_array())
    assert_trees_close(tp, jp, 0.0)
    # And the port's SRN computes the archive's function.
    pa, pb = positions(17, 3), positions(17, 4)
    fa, fb = (tm.encoding({}, torch.from_numpy(p)) for p in (pa, pb))
    with torch.no_grad():
        want = module(fa, fb)[..., 0]
    got = tm(tp, torch.from_numpy(pa), torch.from_numpy(pb))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_torchscript_import_refuses_what_jax_refuses(tmp_path):
    lin = torch.nn.Sequential(torch.nn.Linear(5, 3))
    path = str(tmp_path / "odd.pt")
    torch.save({"encoder.0.weight": lin[0].weight.data,
                "decoder.0.weight": torch.ones(1, 3)}, path)
    for fn in (jax_srn_from_torch_archive, srn_from_torch_archive):
        with pytest.raises(ValueError, match="frequency encoding"):
            fn(path)
    _, path = make_srn_archive(tmp_path, 1)
    for fn in (jax_srn_from_torch_archive, srn_from_torch_archive):
        with pytest.raises(ValueError, match="add_diff needs"):
            fn(path, symmetrizer="add_diff")


# -- training, step for step ----------------------------------------------
#
# Each step is paired: from the port's parameters and Adam state, the
# port takes its step (``mine.adam_step``) and JAX takes its own
# (``value_and_grad`` and ``_adam_update``) on the same batch, and the
# two results are held to each other. Free-running trajectories agree to
# about 1e-7 for most seeds, but a ReLU whose input lies within a rounding
# of zero for some sample switches sides in one package only, and Adam's
# normalized steps carry that to 1e-4-3e-4 within 20 steps (1 seed in 6
# measured); pairing holds every step without that chaos. MINE's
# Donsker–Varadhan bound does not change when T shifts by a constant, so
# the output bias (and a hidden bias whose unit is active on every
# sample) has a gradient of rounding noise in both packages, which Adam
# turns into ±lr steps: MINE is held by its bound, not its parameters.

def paired_steps(init, port_loss, jax_loss, batches, lr, check):
    """Adam steps from the port's parameters in both packages over
    ``batches`` of (the port's batch, JAX's), each pair handed to
    ``check(i, port_next, jax_next, port_loss, jax_loss)``; returns the
    port's parameters after the last step."""
    jgrad = jax.jit(jax.value_and_grad(jax_loss))
    params = init
    state = (tree_map(torch.zeros_like, init),
             tree_map(torch.zeros_like, init))
    for i, (batch, jbatch) in enumerate(batches):
        nxt, nstate, loss = mine.adam_step(
            params, state, lambda p: port_loss(p, batch), lr,
            torch.tensor(float(i + 1)))
        jp = jax_params_of(params)
        jloss, grads = jgrad(jp, jbatch)
        jnext, _ = jax_mine._adam_update(
            jp, grads, tuple(jax_params_of(s) for s in state), lr,
            jnp.float32(i + 1))
        check(i, nxt, jnext, float(loss), float(jloss))
        params, state = nxt, nstate
    return params


@pytest.mark.parametrize("name", ["frequency_add_diff", "hash_grid"])
def test_train_srn_matches_jax_step_for_step(name):
    steps, batch, lr, seed, n = 20, 256, 3e-3, 11, 2000
    jm = jax_mine.CorrelationSRN.create(**SRN_CONFIGS[name])
    tm = mine.CorrelationSRN.create(**SRN_CONFIGS[name])
    pr, pq = positions(n, 5), positions(n, 6)
    target = np.exp(-4.0 * ((pr - pq) ** 2).sum(-1)).astype(np.float32)
    tpr, tpq, tt = (torch.from_numpy(a) for a in (pr, pq, target))
    got, got_loss = mine.train_srn(tm, tpr, tpq, tt, steps=steps,
                                   batch=batch, lr=lr, seed=seed)
    # The port's draws: the initial parameters, then every step's batch.
    gen = torch.Generator().manual_seed(seed)
    init = tm.init(gen)
    idx = torch.randint(0, n, (steps, batch), generator=gen)
    jpr, jpq, jt = (jnp.asarray(a) for a in (pr, pq, target))
    losses = []

    def check(i, nxt, jnext, loss, jloss):
        assert_trees_close(nxt, jnext, ATOL_TRAINED)
        assert abs(loss - jloss) <= ATOL_FORWARD, i
        losses.append(loss)

    params = paired_steps(
        init, lambda p, i: torch.mean((tm(p, tpr[i], tpq[i]) - tt[i]) ** 2),
        lambda p, i: jnp.mean((jm.apply(p, jpr[i], jpq[i]) - jt[i]) ** 2),
        [(i, i.numpy()) for i in idx], lr, check)
    # train_srn is these steps, and its loss the last one's.
    assert_trees_close(got, params, 0.0)
    assert got_loss == losses[-1]
    # The parameters moved by far more than the bar.
    moved = flat(got)
    start = flat(init)
    assert max(float(np.abs(moved[k] - start[k]).max()) for k in moved) \
        > 100 * ATOL_TRAINED


def mine_series(pairs, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(pairs, n)).astype(np.float32)
    w = np.linspace(0.95, 0.0, pairs, dtype=np.float32)[:, None]
    y = (w * x + (1 - w) * rng.normal(size=(pairs, n))).astype(np.float32)
    return x, y


def jax_bound(est, p, x, y, perm):
    """JAX's Donsker–Varadhan bound with an explicit permutation (its
    ``mi_lower_bound`` draws the permutation from a key)."""
    t_joint = est.statistic(p, x, y)
    t_marg = est.statistic(p, x, y[perm])
    return jnp.mean(t_joint) - jnp.log(
        jnp.mean(jnp.exp(jnp.clip(t_marg, -20.0, 20.0))) + 1e-12)


def mine_pairs(test, jest, x, y, inits, perms, lr, steps):
    """Paired steps of each pair's network; every step's bound (before
    and after the step, on the next permutation) held to JAX's. Returns
    the port's parameters of each pair and its last step's loss."""
    out, losses = [], {}
    for p, init in enumerate(inits):
        tx, ty = torch.from_numpy(x[p]), torch.from_numpy(y[p])
        jx, jy = jnp.asarray(x[p]), jnp.asarray(y[p])
        tperm, jperm = torch.from_numpy(perms[:, p]), perms[:, p]

        def check(i, nxt, jnext, loss, jloss):
            losses[p] = loss
            assert abs(loss - jloss) <= ATOL_FORWARD, (p, i)
            after = float(test.mi_lower_bound(nxt, tx, ty, tperm[i + 1]))
            jafter = float(jax_bound(jest, jnext, jx, jy, jperm[i + 1]))
            assert abs(after - jafter) <= ATOL_TRAINED, (p, i)

        out.append(paired_steps(
            init, lambda q, perm: -test.mi_lower_bound(q, tx, ty, perm),
            lambda q, perm: -jax_bound(jest, q, jx, jy, perm),
            [(tperm[i], jperm[i]) for i in range(steps)], lr, check))
    return out, [losses[p] for p in range(len(inits))]


def test_train_mine_matches_jax_step_for_step():
    steps, lr, seed, n = 20, 1e-3, 3, 120
    jest = jax_mine.MineEstimator.create(hidden=16, num_layers=2)
    test = mine.MineEstimator.create(hidden=16, num_layers=2)
    x, y = mine_series(1, n)
    got, got_mi = mine.train_mine(test, torch.from_numpy(x[0]),
                                  torch.from_numpy(y[0]), steps=steps,
                                  lr=lr, seed=seed)
    # The draws: the initial parameters, then every step's permutation.
    gen = torch.Generator().manual_seed(seed)
    init = test.init(gen)
    perms = torch.rand(steps, n, generator=gen).argsort(-1).numpy()
    # One more permutation for the last step's check.
    perms = np.concatenate([perms, perms[:1]])[:, None]
    (params,), (loss,) = mine_pairs(test, jest, x, y, [init], perms, lr,
                                    steps)
    assert_trees_close(got, params, 0.0)
    assert got_mi == -loss


def test_train_mine_batched_matches_jax_pair_by_pair():
    steps, lr, seed, pairs, n = 20, 1e-3, 4, 3, 100
    jest = jax_mine.MineEstimator.create(hidden=16, num_layers=2)
    test = mine.MineEstimator.create(hidden=16, num_layers=2)
    x, y = mine_series(pairs, n, 1)
    got = mine.train_mine_batched(test, torch.from_numpy(x),
                                  torch.from_numpy(y), steps=steps, lr=lr,
                                  seed=seed)
    assert got.shape == (pairs,)
    # The draws: each pair's initial parameters in turn, then every
    # step's permutations and the final bound's.
    gen = torch.Generator().manual_seed(seed)
    inits = [test.init(gen) for _ in range(pairs)]
    perms = torch.rand(steps + 1, pairs, n, generator=gen).argsort(-1)
    perms = perms.numpy()
    params, _ = mine_pairs(test, jest, x, y, inits, perms, lr, steps)
    for p in range(pairs):
        # The stacked networks step as each pair's own network.
        want = max(float(test.mi_lower_bound(
            params[p], torch.from_numpy(x[p]), torch.from_numpy(y[p]),
            torch.from_numpy(perms[steps, p]))), 0.0)
        assert float(got[p]) == pytest.approx(want, abs=ATOL_FORWARD), p
    assert float(got[0]) > float(got[-1])  # dependent above independent


def test_train_srn_converges_on_a_smooth_field():
    # The one case trained to convergence (tests/test_models.py's).
    rng = np.random.default_rng(0)
    pr = rng.uniform(size=(4000, 3)).astype(np.float32)
    pq = rng.uniform(size=(4000, 3)).astype(np.float32)
    target = np.exp(-8.0 * ((pr - pq) ** 2).sum(-1)).astype(np.float32)
    model = mine.CorrelationSRN.create(hidden=32, latent=16,
                                       num_frequencies=4)
    params, loss = mine.train_srn(
        model, torch.from_numpy(pr), torch.from_numpy(pq),
        torch.from_numpy(target), steps=800, batch=1024, lr=1e-2)
    assert loss < 0.02
    a = model(params, torch.from_numpy(pr[:10]), torch.from_numpy(pq[:10]))
    b = model(params, torch.from_numpy(pq[:10]), torch.from_numpy(pr[:10]))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
