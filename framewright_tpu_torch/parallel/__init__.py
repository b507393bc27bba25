"""Scale-out: the frames split over the local cards (``mesh``,
``distributor.ShardedFrameProcessor``, ``distributor.ShardedSR``), the
scene-chunk queue (``distributor``), the process group (``dcn``) and the
shared-directory render farm (``multihost``)."""

from framewright_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    build_mesh,
    frame_split,
    pad_batch_for_mesh,
    shard_frames,
)
