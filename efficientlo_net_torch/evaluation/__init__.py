"""Streaming odometry, sequence evaluation, trajectories and KITTI metrics."""
