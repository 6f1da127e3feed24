"""Multi-rank parallelism on ``torch.distributed``: meshes, local blocks,
distributed estimators, the halo exchange and the sharded shear-warp.

Counterpart of ``correrender_tpu/parallel``. Two mesh axes:

* ``"space"``: voxel-parallel, the volume's Z axis block-sharded;
  per-voxel estimators need no communication (a halo exchange for
  spatial stencils at block edges).
* ``"members"``: member-parallel for large ensembles: Pearson all-reduces
  partial sums; the rank and kNN measures all-gather the member axis of
  each voxel block.

Beside them: the sharded shear-warp DVR and isosurface renderers
(``dvr_sharded``, ``iso_sharded``), the multi-GB stress runs
(``stress``) and the multi-process path (``multihost``, one device a
process; ``multihost_worker`` runs it in each process and its
``launch`` starts local processes).
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
from correrender_tpu_torch.parallel.iso_sharded import iso_shearwarp_sharded
from correrender_tpu_torch.parallel.multihost import (
    initialize_process,
    member_series_from_local,
    member_stack_from_local,
    process_member_range,
    process_spanning_mesh,
    replicate_to_host,
)
from correrender_tpu_torch.parallel.stress import (
    stress_config5,
    stress_pearson,
    stress_rank_ksg,
    stress_reshard,
)

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
    "iso_shearwarp_sharded",
    "stress_pearson",
    "stress_reshard",
    "stress_rank_ksg",
    "stress_config5",
    "initialize_process",
    "process_spanning_mesh",
    "process_member_range",
    "member_stack_from_local",
    "member_series_from_local",
    "replicate_to_host",
]
