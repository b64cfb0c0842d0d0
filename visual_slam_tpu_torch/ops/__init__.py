"""Tensor operations of the port; each module mirrors ``visual_slam_tpu.ops``."""
