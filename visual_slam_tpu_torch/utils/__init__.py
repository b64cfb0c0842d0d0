"""Host utilities (port of ``visual_slam_tpu.utils``): trajectory metrics,
checkpoint files, logging, profiling."""
