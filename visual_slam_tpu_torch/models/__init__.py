"""End-to-end SLAM systems and pipeline families (port of
``visual_slam_tpu.models``):

  * MonoVO     -- monocular SLAM (two-view init, PnP tracking, LM-BA)
  * CompiledVO -- the fused device-resident per-frame step
  * BatchedVO  -- data-parallel multi-sequence VO
  * StereoVO   -- stereo SLAM, metric from the first frame
  * RGBDVO     -- RGB-D SLAM, metric landmarks from depth maps
  * CompiledSLAM -- the mono chunked main path
"""

from .compiled_slam import CompiledSLAM  # noqa: F401
from .families import BatchedVO, CompiledVO, MonoVO, RGBDVO, StereoVO  # noqa: F401
