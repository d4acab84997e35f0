"""PyTorch / CUDA port of efficientlo_net_tpu for NVIDIA Hopper (H100).

Eval-mode streaming odometry, the train step, the trainer with its loader
and checkpoints, sequence evaluation, and the SLAM backend (pose graph,
scan factors, sliding-window SLAM with loop closures measured by the
network, map assembly): projection, preprocessing, the PWCLO network, the
multi-level loss, the optimizer, KITTI metrics and the windowed
neighbour-select kernels (``ops/csrc/window_select.cu``).  The JAX package
is the reference the port is tested against; nothing of it is imported here.
"""
