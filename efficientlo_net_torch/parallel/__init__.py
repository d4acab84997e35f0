"""Parallelism of the port: ``torch.distributed`` with one process per
device, PyTorch's counterpart of the JAX package's device mesh.

* ``distributed``: process-group start-up, host-sharded evaluation and the
  collectives the other modules use;
* ``mesh``: ``DeviceMesh``es with a ``data`` (and a ``ring``) dimension and
  this rank's share of a global batch;
* ``data_parallel``: the data-parallel train step and state replication;
* ``ring``: the W-axis (azimuth) ring for the windowed neighbour selects.
"""
