"""The benchmark of efficientlo_net_torch on one H100: see README.md and run.py."""
