"""Loop closing: signature shortlist, batched Hamming match (kernel K4),
PnP verification and Sim(3)/SE(3) pose-graph optimization
(port of ``visual_slam_tpu.loop_closing``)."""

from .pose_graph import PoseGraph, build_sequential_graph, optimize_pose_graph  # noqa: F401
from .loop_closing import LoopClosing  # noqa: F401
