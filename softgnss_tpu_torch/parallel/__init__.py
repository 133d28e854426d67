"""Distribution layer: process meshes, sharded acquisition and tracking, and
the streamed tracker (softgnss_tpu.parallel on ``torch.distributed``).

* **PRN sharding** of the acquisition search grid over the mesh's channel
  dimension (:func:`acquire_sharded`),
* **channel sharding** of tracking: each rank tracks its rows of the
  channel set over the whole capture (exact, :func:`track_channels_sharded`),
* **time-block sharding** of tracking: each rank tracks one block of the
  capture from an analytically propagated state, re-locking over
  ``config.time_shard_warmup_ms`` (:func:`track_time_sharded`),
* **exact time blocking**: sequential channel-sharded blocks that carry the
  loop state (:func:`track_time_exact`),
* **stage overlap**: tracking in time chunks whose upload, compute and
  readback overlap (:func:`track_streamed`, optionally channel-sharded),
* process groups and meshes (:func:`initialize_distributed`,
  :func:`make_mesh`, :func:`receiver_mesh`; parallel.mesh).

Every rank of a mesh calls an entry point with the same arguments and gets
the whole result back.
"""

from softgnss_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
    receiver_mesh,
)
from softgnss_tpu_torch.parallel.acquire import acquire_sharded  # noqa: F401
from softgnss_tpu_torch.parallel.stream import track_streamed  # noqa: F401
from softgnss_tpu_torch.parallel.track import (  # noqa: F401
    track_channels_sharded,
    track_time_exact,
    track_time_sharded,
)
