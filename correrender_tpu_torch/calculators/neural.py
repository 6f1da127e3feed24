"""Neural correlation calculator.

Counterpart of ``correrender_tpu/calculators/neural.py``, the one
calculator behind the reference's PyTorch / tiny-cuda-nn / QuickMLP /
VMLP backends (SURVEY.md §2.4): an SRN
(:class:`~correrender_tpu_torch.models.mine.CorrelationSRN`) trained once
on computed correlation fields, or loaded from a preset or a published
archive, answers each reference-point move with one MLP pass over the
grid. Voxels whose member series holds a NaN are left out of training
and come out NaN (the NaN stencil).

It departs from the JAX module in how it holds data, not in what it
computes:

* The training set keeps, for each reference point, its position and
  the valid voxels' indices and field values (:class:`TrainingSet`), and
  builds a batch's positions from them; JAX concatenates the positions
  themselves (28 bytes a sample against 8: about 14 GB at 250³ with 32
  reference points). The samples, their order and the uniform draw over
  them are the same.
* ``compute`` encodes the reference point once and broadcasts its latent,
  and evaluates the grid in Z-slabs under ``FIELD_BUDGET_BYTES`` of
  activations; JAX encodes the broadcast reference once a voxel in one
  jitted program. The function is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.calculators.base import (
    Calculator,
    register_calculator_type,
    stack_slabs,
)
from correrender_tpu_torch.calculators.correlation import correlate_field
from correrender_tpu_torch.models.checkpoint import load_params, save_params
from correrender_tpu_torch.models.mine import CorrelationSRN, fit_srn
from correrender_tpu_torch.models.tree import tree_map

#: Activation bytes a Z-slab of the whole-grid MLP pass may take.
FIELD_BUDGET_BYTES = 1 << 30


def _axis_positions(n: int, device) -> torch.Tensor:
    """``(i + 0.5) / n`` in float32, the JAX package's voxel centres
    (divided by a tensor: the card divides by a Python number as a
    product with its reciprocal)."""
    return ((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
            / torch.full((), float(n), device=device))


def _point_position(point, grid, device) -> torch.Tensor:
    """A voxel's normalized xyz centre as the JAX package builds a
    reference position: in float64, then rounded to float32."""
    x, y, z = point
    # Staged without waiting for the stream (a pageable copy otherwise
    # waits for the work queued before it).
    return torch.tensor([(x + 0.5) / grid.xs, (y + 0.5) / grid.ys,
                         (z + 0.5) / grid.zs], dtype=torch.float32).to(
                             device, non_blocking=True)


class TrainingSet:
    """The fit's samples: for each reference point in turn, the voxels
    where its field is valid (flat ``(Z, Y, X)`` indices, ascending) and
    the field there. Sample ``k`` of the concatenation is the JAX
    package's sample ``k``: (the reference's position, the voxel's
    position, the field value)."""

    def __init__(self, grid, ref_pos: torch.Tensor, voxels: torch.Tensor,
                 targets: torch.Tensor, counts: torch.Tensor):
        self.ref_pos = ref_pos  # (R, 3) float32
        self.voxels = voxels  # (N,) int32
        self.targets = targets  # (N,) float32
        self.ends = torch.cumsum(counts, 0)  # (R,) int64
        device = targets.device
        self._axes = [_axis_positions(n, device)
                      for n in (grid.xs, grid.ys, grid.zs)]
        self._xs, self._ys = grid.xs, grid.ys

    def __len__(self) -> int:
        return self.targets.shape[0]

    def take(self, idx: torch.Tensor):
        """(pos_ref, pos_query, targets) of samples ``idx``."""
        ref = torch.searchsorted(self.ends, idx, right=True)
        vox = self.voxels[idx].to(torch.int64)
        cx, cy, cz = self._axes
        pos = torch.stack([cx[vox % self._xs], cy[vox // self._xs % self._ys],
                           cz[vox // (self._xs * self._ys)]], dim=-1)
        return self.ref_pos[ref], pos, self.targets[idx]

    def materialise(self):
        """Every sample: the JAX package's concatenated arrays."""
        return self.take(torch.arange(len(self), device=self.targets.device))


@register_calculator_type("correlation_vmlp")
class NeuralCorrelationCalculator(Calculator):
    """SRN-backed correlation field: train once on a computed field (or
    load pretrained params), then answer reference-point moves with a
    single MLP forward pass over the voxel grid."""

    def __init__(
        self,
        field_name: str | None = None,
        measure: str = "pearson",
        reference_point=(0, 0, 0),
        model: CorrelationSRN | None = None,
        params=None,
        train_steps: int = 300,
        weights_path: str | None = None,
        output_name=None,
    ):
        super().__init__(output_name)
        self.field_name = field_name
        self.measure = measure
        self.reference_point = tuple(int(c) for c in reference_point)
        self.model = model or CorrelationSRN.create()
        self.params = params
        self.train_steps = train_steps
        self.weights_path = weights_path
        self._stencil = None  # ((field, time), (Z, Y, X) valid mask)
        #: (field_name, time) the current params were auto-fit on: a
        #: field or time switch retrains. None for preset or imported
        #: weights (the user's explicit choice, kept across switches
        #: like the reference's fixed published networks).
        self._fit_key = None
        if weights_path is not None:
            self.load_weights(weights_path)

    def default_output_name(self):
        return f"Neural Correlation ({self.field_name})"

    # -- settings round trip: a state file keeps the model's source ------

    @classmethod
    def settings_to_kwargs(cls, s: dict) -> dict:
        kwargs = {}
        if "scalar_field_name" in s:
            kwargs["field_name"] = s["scalar_field_name"]
        if "correlation_measure_type" in s:
            kwargs["measure"] = s["correlation_measure_type"]
        if "reference_point_x" in s:
            kwargs["reference_point"] = (
                int(s.get("reference_point_x", 0)),
                int(s.get("reference_point_y", 0)),
                int(s.get("reference_point_z", 0)),
            )
        if "model_preset_path" in s and s["model_preset_path"]:
            kwargs["weights_path"] = s["model_preset_path"]
        if "train_steps" in s:
            kwargs["train_steps"] = int(s["train_steps"])
        return kwargs

    def get_settings(self) -> dict:
        return {
            "scalar_field_name": self.field_name,
            "correlation_measure_type": self.measure,
            "reference_point_x": self.reference_point[0],
            "reference_point_y": self.reference_point[1],
            "reference_point_z": self.reference_point[2],
            "model_preset_path": self.weights_path or "",
            "train_steps": self.train_steps,
        }

    # -- weights: .npz presets carrying the model's config, or published
    # -- PyTorch/TorchScript archives (PyTorchCorrelationCalculator.cpp:261)

    def save_weights(self, path: str) -> None:
        """Persist trained params + model config as one ``.npz`` preset."""
        if self.params is None:
            raise ValueError("no trained parameters to save")
        save_params(path, {"config": self.model.config_array(),
                           "params": self.params})

    def load_weights(self, path: str) -> None:
        """Load an ``.npz`` preset (the model rebuilt from its embedded
        config) or a published archive (``.pt``/``.pth``/``.ts``, mapped
        by ``models/torch_import.py``). The parameters land on the CPU
        and move to the volume's device at the next ``compute``."""
        self._fit_key = None  # preset weights: explicit user choice
        if path.endswith((".pt", ".pth", ".ts")):
            from correrender_tpu_torch.models.torch_import import (
                srn_from_torch_archive)

            self.model, self.params = srn_from_torch_archive(path)
            return
        with np.load(path) as data:
            cfg = data["config"]
        self.model = CorrelationSRN.from_config_array(cfg)
        template = {"config": cfg,
                    "params": self.model.init(torch.Generator())}
        self.params = load_params(path, template)["params"]

    # -- NaN stencil (DeepLearningCorrelationCalculator.hpp:101-104) -----

    def _nan_stencil(self, stack, time: int) -> torch.Tensor:
        """(Z, Y, X) bool, True where the full series is finite. Cached
        per (field, time): time-varying NaN patterns and field switches
        must not leak a stale mask."""
        key = (self.field_name, time)
        if self._stencil is None or self._stencil[0] != key:
            self._stencil = (key, torch.cat([
                torch.isfinite(slab).all(dim=-1)
                for _, slab in stack_slabs(stack)]))
        return self._stencil[1]

    def _grid_positions(self, z0: int = 0, z1: int | None = None):
        """(Z, Y, X, 3) voxel centres of planes ``z0:z1``, xyz order."""
        g = self.volume_data.grid
        dev = self.volume_data.device
        z, y, x = torch.meshgrid(_axis_positions(g.zs, dev)[z0:z1],
                                 _axis_positions(g.ys, dev),
                                 _axis_positions(g.xs, dev), indexing="ij")
        return torch.stack([x, y, z], dim=-1)

    def _member_stack(self, time: int):
        vd = self.volume_data
        return vd.get_member_stack(self.field_name or vd.field_names[0],
                                   time)

    def training_set(self, time: int = 0, num_reference_points: int = 32,
                     seed=0) -> TrainingSet:
        """The fit's samples: reference points drawn from the valid
        voxels with ``np.random.default_rng(seed)`` (the JAX package's
        draw), each one's field from ``correlate_field`` (a kernel launch
        a reference point), its valid voxels those of the stencil where
        the field is finite."""
        vd = self.volume_data
        g = vd.grid
        stack = self._member_stack(time)
        stencil = self._nan_stencil(stack, time).reshape(-1)
        valid_flat = torch.nonzero(stencil).squeeze(1)
        if valid_flat.numel() == 0:
            raise ValueError(
                "every voxel series contains NaN members — nothing to "
                "train the neural correlation surrogate on")
        rng = np.random.default_rng(seed)
        refs, voxels, targets = [], [], []
        for _ in range(num_reference_points):
            flat_idx = int(valid_flat[rng.integers(0, valid_flat.numel())])
            rz, rem = divmod(flat_idx, g.ys * g.xs)
            ry, rx = divmod(rem, g.xs)
            field = correlate_field(stack, stack[rz, ry, rx],
                                    self.measure).reshape(-1)
            vox = torch.nonzero(torch.isfinite(field) & stencil).squeeze(1)
            refs.append(_point_position((rx, ry, rz), g, vd.device))
            voxels.append(vox.to(torch.int32))
            targets.append(field[vox])
        return TrainingSet(
            g, torch.stack(refs), torch.cat(voxels), torch.cat(targets),
            torch.tensor([v.numel() for v in voxels], device=vd.device))

    def fit(self, time: int = 0, num_reference_points: int = 32, seed=0):
        """Supervised fit against the classical estimator on sampled
        reference points (the SSDBM-2024 style training loop); returns
        the last step's loss."""
        samples = self.training_set(time, num_reference_points, seed)
        self.params, loss = fit_srn(self.model, len(samples), samples.take,
                                    steps=self.train_steps,
                                    device=self.volume_data.device)
        self._fit_key = (self.field_name, time)
        return loss

    def compute(self, time: int, member: int):
        # Retrain when the auto-fit params no longer describe the
        # selected data (a field switch, a time scrub); preset and
        # imported params (_fit_key None) are kept.
        if self.params is None or (
            self._fit_key is not None
            and self._fit_key != (self.field_name, time)
        ):
            self.fit(time)
        vd = self.volume_data
        g = vd.grid
        self.params = tree_map(lambda a: a.to(vd.device), self.params)
        model, params = self.model, self.params
        per_voxel = 8 * (model.encoding.num_features
                         + 4 * model.encoder.hidden
                         + 4 * model.encoder.out_features)
        planes = max(FIELD_BUDGET_BYTES // (per_voxel * g.ys * g.xs), 1)
        out = torch.empty(g.zs, g.ys, g.xs, device=vd.device)
        with torch.no_grad():
            ea = model.encode(params, _point_position(self.reference_point,
                                                      g, vd.device))
            for z0 in range(0, g.zs, planes):
                eb = model.encode(params, self._grid_positions(z0,
                                                               z0 + planes))
                out[z0:z0 + planes] = model.decode(params, ea, eb)
        stencil = self._nan_stencil(self._member_stack(time), time)
        return torch.where(stencil, out, torch.nan)

    def set_reference_point(self, x, y, z):
        self.reference_point = (x, y, z)
        if self.volume_data is not None:
            self.volume_data.mark_dirty(self.output_name)
