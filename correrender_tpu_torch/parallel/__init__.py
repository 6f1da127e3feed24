"""Multi-rank parallelism on ``torch.distributed``: meshes, local blocks,
distributed estimators, the halo exchange and the sharded shear-warp.

Counterpart of ``correrender_tpu/parallel``. Two mesh axes:

* ``"space"``: voxel-parallel, the volume's Z axis block-sharded;
  per-voxel estimators need no communication (a halo exchange for
  spatial stencils at block edges).
* ``"members"``: member-parallel for large ensembles: Pearson all-reduces
  partial sums; the rank and kNN measures all-gather the member axis of
  each voxel block.

The sharded isosurface renderer, the stress harness and the multi-host
entry points (``iso_sharded``, ``stress``, ``multihost``,
``multihost_worker``) are not ported yet (ROADMAP A.13): their names
raise ``NotImplementedError`` here.
"""

from correrender_tpu_torch.parallel.mesh import (
    gather_member_stack,
    gather_z,
    make_mesh,
    reshard_member_to_space,
    reshard_space_to_member,
    shard_member_stack,
    space_only_mesh,
)
from correrender_tpu_torch.parallel.pearson_sharded import (
    correlate_member_sharded,
    correlate_space_sharded,
    pearson_member_sharded,
)
from correrender_tpu_torch.parallel.halo import (
    exchange_halo_z,
    gaussian_blur_3d_sharded,
    make_sharded_stencil,
)
from correrender_tpu_torch.parallel.dvr_sharded import dvr_shearwarp_sharded

__all__ = [
    "make_mesh",
    "shard_member_stack",
    "gather_member_stack",
    "gather_z",
    "space_only_mesh",
    "reshard_member_to_space",
    "reshard_space_to_member",
    "pearson_member_sharded",
    "correlate_member_sharded",
    "correlate_space_sharded",
    "exchange_halo_z",
    "make_sharded_stencil",
    "gaussian_blur_3d_sharded",
    "dvr_shearwarp_sharded",
]

#: Names of the JAX package's parallel modules that wait for ROADMAP A.13.
_NOT_PORTED = {
    "iso_shearwarp_sharded": "iso_sharded",
    "stress_pearson": "stress", "stress_reshard": "stress",
    "stress_rank_ksg": "stress", "stress_config5": "stress",
    "initialize_process": "multihost", "process_spanning_mesh": "multihost",
    "process_member_range": "multihost",
    "member_stack_from_local": "multihost",
    "member_series_from_local": "multihost",
    "replicate_to_host": "multihost", "multihost_worker": "multihost_worker",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} (parallel/{_NOT_PORTED[name]}.py in the JAX package) "
            "is not ported yet (ROADMAP A.13)")
    raise AttributeError(name)
