"""PyTorch / CUDA port of efficientlo_net_tpu for NVIDIA Hopper (H100).

Eval-mode streaming odometry and the train step: projection, preprocessing,
the PWCLO network, the multi-level loss, the optimizer and the windowed
neighbour-select kernels (``ops/csrc/window_select.cu``).  The JAX package
is the reference the port is tested against; nothing of it is imported here.
"""
