"""Neural correlation estimators: the SRN and MINE network families.

Counterpart of ``correrender_tpu/models/mine.py`` (reference NetworkType
{MINE, SRN_MINE, SRN}, src/Calculators/CorrelationDefines.hpp:81-99).

* **SRN** (scene representation network): encoder(position_ref),
  encoder(position_query) → symmetrizer → decoder → correlation value,
  trained supervised against computed correlation fields.
* **MINE** (Belghazi et al. 2018, arXiv:1801.04062): the statistic
  network T(x, y) trained on the Donsker–Varadhan bound
  ``MI ≥ E_joint[T] − log E_marginal[exp T]``.

The trainers run an eager step loop on the tensors' device (the JAX
package jits the whole schedule into one ``fori_loop``) with the JAX
package's Adam step (:func:`_adam_update`). Every random draw (the
initial parameters, the batch indices, MINE's permutations) comes from
one CPU ``torch.Generator`` seeded with ``seed`` and is then moved to the
device, so the card and the CPU draw the same; ``jax.random``'s draws
are not reproduced.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from correrender_tpu_torch.models.encodings import (
    FrequencyEncoding,
    HashGridEncoding,
)
from correrender_tpu_torch.models.symmetrizer import (
    symmetrize,
    symmetrizer_output_features,
)
from correrender_tpu_torch.models.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from correrender_tpu_torch.models.vmlp import MLP


def _adam_update(params, grads, state, lr, t):
    """One Adam step as the JAX package takes it: ``p − lr·m̂/(√v̂ +
    1e-8)``, with ``t`` (from 1) a float32 tensor, the bias corrections
    computed in float32 and divided by as tensors."""
    m, v = state
    m = tree_map(lambda a, g: 0.9 * a + 0.1 * g, m, grads)
    v = tree_map(lambda a, g: 0.999 * a + 0.001 * g * g, v, grads)
    c1 = 1 - torch.full_like(t, 0.9) ** t
    c2 = 1 - torch.full_like(t, 0.999) ** t
    params = tree_map(
        lambda p, a, b: p - lr * (a / c1) / (torch.sqrt(b / c2) + 1e-8),
        params, m, v)
    return params, (m, v)


def adam_step(params, state, loss_fn, lr: float, t: torch.Tensor):
    """One Adam step of ``loss_fn(params)``: returns the updated
    parameters and Adam state ``(m, v)`` (trees like ``params``) and the
    loss, evaluated before the update."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        params, state = _adam_update(tree_unflatten(params, leaves),
                                     tree_unflatten(params, grads), state,
                                     lr, t)
    return tree_map(torch.Tensor.detach, params), state, loss.detach()


def _minimize(params, loss_fn, steps: int, lr: float):
    """Adam over ``steps`` steps of ``loss_fn(params, i)`` (step i from
    0, ``t = i + 1``): the parameters after the last step and the last
    step's loss, evaluated before its update."""
    device = tree_leaves(params)[0].device
    ts = torch.arange(1, steps + 1, dtype=torch.float32, device=device)
    state = (tree_map(torch.zeros_like, params),
             tree_map(torch.zeros_like, params))
    loss = torch.tensor(float("inf"))
    for i in range(steps):
        params, state, loss = adam_step(
            params, state, lambda p: loss_fn(p, i), lr, ts[i])
    return params, loss


class CorrelationSRN(nn.Module):
    """Encoder–symmetrizer–decoder correlation surrogate."""

    def __init__(self, encoding=None, encoder: MLP = None,
                 decoder: MLP = None, symmetrizer: str = "add_diff"):
        super().__init__()
        self.encoding = encoding
        self.encoder = encoder
        self.decoder = decoder
        self.symmetrizer = symmetrizer

    @classmethod
    def create(cls, hidden=64, latent=32, num_frequencies=6,
               symmetrizer="add_diff", encoding="frequency",
               hash_levels=8, hash_features=2, hash_log2_size=15,
               hash_base_res=4, hash_per_level_scale=1.6):
        """``encoding="hash_grid"`` uses the instant-NGP multiresolution
        grid (the tiny-cuda-nn encoder the SSDBM'24 networks train with)
        instead of the frequency encoding."""
        if encoding == "hash_grid":
            enc = HashGridEncoding(
                dims=3, num_levels=hash_levels,
                features_per_level=hash_features,
                log2_hashmap_size=hash_log2_size,
                base_resolution=hash_base_res,
                per_level_scale=hash_per_level_scale,
            )
        else:
            enc = FrequencyEncoding(dims=3, num_frequencies=num_frequencies)
        encoder = MLP(enc.num_features, hidden, latent, num_layers=2)
        decoder = MLP(symmetrizer_output_features(latent, symmetrizer),
                      hidden, 1, num_layers=2)
        return cls(encoding=enc, encoder=encoder, decoder=decoder,
                   symmetrizer=symmetrizer)

    _SYMMETRIZERS = ("add", "add_diff", "mul")
    _ACTIVATIONS = ("relu", "snake", "snake_alt", "none")

    def config_array(self):
        """Hyperparameters as a small int64 array, the JAX package's
        layout: it rides inside ``.npz`` presets, so loading needs no
        side-channel config. A hash grid's ``per_level_scale`` is stored
        as its float64 bit pattern (the per-level table shapes depend on
        ``floor(base·scale^level)``, so a lossy scale could rebuild
        tables of other sizes)."""
        if isinstance(self.encoding, HashGridEncoding):
            enc_kind = 1
            freq = 0
            hash_cfg = [
                self.encoding.num_levels,
                self.encoding.features_per_level,
                self.encoding.log2_hashmap_size,
                self.encoding.base_resolution,
                int(np.float64(self.encoding.per_level_scale)
                    .view(np.int64)),
            ]
        else:
            enc_kind = 0
            freq = self.encoding.num_frequencies
            hash_cfg = [0, 0, 0, 0, 0]
        return np.asarray([
            self.encoder.hidden,
            self.encoder.out_features,
            freq,
            self._SYMMETRIZERS.index(self.symmetrizer),
            self.encoder.num_layers,
            self.decoder.num_layers,
            self._ACTIVATIONS.index(self.encoder.activation),
            enc_kind,
            *hash_cfg,
        ], np.int64)

    @classmethod
    def from_config_array(cls, cfg):
        hidden, latent = int(cfg[0]), int(cfg[1])
        num_frequencies = int(cfg[2])
        symmetrizer = cls._SYMMETRIZERS[int(cfg[3])]
        # Older 4-element presets predate the depth/activation fields;
        # 7-element ones predate the encoding-kind fields.
        enc_layers = int(cfg[4]) if len(cfg) > 4 else 2
        dec_layers = int(cfg[5]) if len(cfg) > 5 else 2
        activation = (cls._ACTIVATIONS[int(cfg[6])]
                      if len(cfg) > 6 else "relu")
        if len(cfg) > 7 and int(cfg[7]) == 1:
            raw = int(cfg[12])
            if 0 < raw < 100_000:
                # Legacy ×1000-quantized presets (pre bit-pattern): the
                # bit patterns of real scales (≥ 1.0) exceed 2^62.
                scale = raw / 1000.0
            else:
                scale = float(np.int64(raw).view(np.float64))
            enc = HashGridEncoding(
                dims=3,
                num_levels=int(cfg[8]),
                features_per_level=int(cfg[9]),
                log2_hashmap_size=int(cfg[10]),
                base_resolution=int(cfg[11]),
                per_level_scale=scale,
            )
        else:
            enc = FrequencyEncoding(dims=3, num_frequencies=num_frequencies)
        return cls(
            encoding=enc,
            encoder=MLP(enc.num_features, hidden, latent,
                        num_layers=enc_layers, activation=activation),
            decoder=MLP(symmetrizer_output_features(latent, symmetrizer),
                        hidden, 1, num_layers=dec_layers,
                        activation=activation),
            symmetrizer=symmetrizer,
        )

    def init(self, generator=None, device=None):
        return {
            "encoding": self.encoding.init(generator, device),
            "encoder": self.encoder.init(generator, device),
            "decoder": self.decoder.init(generator, device),
        }

    def encode(self, params, pos):
        """(..., 3) normalized positions → (..., latent)."""
        return self.encoder(params["encoder"],
                            self.encoding(params["encoding"], pos))

    def decode(self, params, ea, eb):
        """Latents of the reference and the query (broadcast against
        each other) → (...,) correlation."""
        ea, eb = torch.broadcast_tensors(ea, eb)
        z = symmetrize(ea, eb, self.symmetrizer)
        return self.decoder(params["decoder"], z)[..., 0]

    def forward(self, params, pos_ref, pos_query):
        """pos_*: (..., 3) normalized positions → (...,) correlation."""
        return self.decode(params, self.encode(params, pos_ref),
                           self.encode(params, pos_query))


def fit_srn(model: CorrelationSRN, n: int, take, steps: int = 500,
            batch: int = 4096, lr: float = 3e-3, seed: int = 0,
            device=None):
    """Supervised fit of the SRN to a sample set of ``n`` (ref, query) →
    correlation samples, which ``take(idx)`` returns for indices on
    ``device`` as ``(pos_ref, pos_query, targets)``.

    The draws, from one CPU generator seeded with ``seed``: the initial
    parameters (:meth:`CorrelationSRN.init`), then every step's batch
    indices at once, ``torch.randint(0, n, (steps, min(batch, n)))``.
    Returns ``(params, last step's loss)``."""
    gen = torch.Generator().manual_seed(seed)
    params = model.init(gen, device)
    idx = torch.randint(0, n, (steps, min(batch, n)),
                        generator=gen).to(device)

    def loss_fn(p, i):
        pos_ref, pos_query, targets = take(idx[i])
        return torch.mean((model(p, pos_ref, pos_query) - targets) ** 2)

    params, loss = _minimize(params, loss_fn, steps, lr)
    return params, float(loss)


def train_srn(model: CorrelationSRN, pos_ref: torch.Tensor,
              pos_query: torch.Tensor, targets: torch.Tensor,
              steps: int = 500, batch: int = 4096, lr: float = 3e-3,
              seed: int = 0):
    """Supervised fit of the SRN to (ref, query) → correlation samples
    (:func:`fit_srn` over the concatenated arrays)."""
    return fit_srn(model, targets.shape[0],
                   lambda i: (pos_ref[i], pos_query[i], targets[i]),
                   steps=steps, batch=batch, lr=lr, seed=seed,
                   device=targets.device)


class MineEstimator(nn.Module):
    """MINE statistic network over scalar sample pairs."""

    def __init__(self, network: MLP = None):
        super().__init__()
        self.network = network

    @classmethod
    def create(cls, hidden=64, num_layers=3):
        return cls(network=MLP(2, hidden, 1, num_layers=num_layers))

    def init(self, generator=None, device=None):
        return self.network.init(generator, device)

    def forward(self, params, x, y):
        """The statistic T(x, y) of samples (..., n)."""
        return self.network(params, torch.stack([x, y], dim=-1))[..., 0]

    statistic = forward

    def mi_lower_bound(self, params, x, y, perm):
        """Donsker–Varadhan bound on samples (..., n), the marginal
        drawn by permuting ``y`` along its last axis with ``perm`` (the
        JAX package draws the permutation from a key here)."""
        t_joint = self.statistic(params, x, y)
        y_shuffled = torch.gather(y, -1, perm.to(torch.int64))
        t_marg = self.statistic(params, x, y_shuffled)
        return t_joint.mean(dim=-1) - torch.log(
            torch.exp(torch.clamp(t_marg, -20.0, 20.0)).mean(dim=-1)
            + 1e-12)


def _permutations(gen, shape, n: int, device):
    """Uniform random permutations of ``range(n)`` of ``shape + (n,)``,
    drawn at once on the CPU (the argsort of uniforms)."""
    return torch.rand(tuple(shape) + (n,), generator=gen).argsort(
        dim=-1).to(device)


def train_mine(estimator: MineEstimator, x: torch.Tensor, y: torch.Tensor,
               steps: int = 400, lr: float = 1e-3, seed: int = 0):
    """Train the statistic net on one (x, y) sample set; returns
    (params, MI estimate in nats: the last step's bound, before its
    update). The draws: the initial parameters, then every step's
    permutation at once."""
    gen = torch.Generator().manual_seed(seed)
    params = estimator.init(gen, x.device)
    perms = _permutations(gen, (steps,), x.shape[-1], x.device)
    params, loss = _minimize(
        params, lambda p, i: -estimator.mi_lower_bound(p, x, y, perms[i]),
        steps, lr)
    return params, -float(loss)


def train_mine_batched(estimator: MineEstimator, xs: torch.Tensor,
                       ys: torch.Tensor, steps: int = 300, lr: float = 1e-3,
                       seed: int = 0) -> torch.Tensor:
    """Train P independent MINE statistic nets at once.

    The reference's neural time-series mode evaluates an estimator per
    heatmap cell (TimeSeriesCorrelationRenderer.cu). The P networks'
    parameters are stacked on a leading axis (the MLP's batched
    product), and each Adam step updates all of them: the summed loss's
    gradient is each network's own. The draws: P initial parameter sets
    in turn, then the permutations of every step and of the final bound,
    ``(steps + 1, P, n)``.

    Args:
      xs, ys: ``(P, n)`` sample series per pair.

    Returns:
      ``(P,)`` MI lower-bound estimates (nats) from the trained nets,
      at least 0.
    """
    p_count, n = xs.shape
    gen = torch.Generator().manual_seed(seed)
    inits = [estimator.init(gen, xs.device) for _ in range(p_count)]
    params = tree_map(lambda *leaves: torch.stack(leaves), *inits)
    perms = _permutations(gen, (steps + 1, p_count), n, xs.device)
    params, _ = _minimize(
        params,
        lambda p, i: -estimator.mi_lower_bound(p, xs, ys, perms[i]).sum(),
        steps, lr)
    with torch.no_grad():
        mi = estimator.mi_lower_bound(params, xs, ys, perms[steps])
    return torch.clamp(mi, min=0.0)
