"""PyTorch / CUDA port of efficientlo_net_tpu for NVIDIA Hopper (H100).

Eval-mode streaming odometry: projection, the PWCLO network and the
windowed neighbour-select kernels (``ops/csrc/window_select.cu``).  The JAX
package is the reference the port is tested against; nothing of it is
imported here.
"""
