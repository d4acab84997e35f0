"""Streaming odometry."""
