"""Multi-sequence execution (port of ``visual_slam_tpu.parallel``): the
batched VO step over a mesh of one card. Landmark-sharded bundle
adjustment, the front-end/back-end pipeline and meshes of more than one
device belong to ROADMAP M14."""

from .mesh import Mesh, make_mesh  # noqa: F401
from .multiseq import batched_track_step, make_batched_vo, shard_batch  # noqa: F401
