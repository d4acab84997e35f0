"""Operators: quaternions, projection, neighbour select and its CUDA kernels."""
