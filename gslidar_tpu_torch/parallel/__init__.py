"""Multi-GPU: camera-data-parallel training and sharded 360° renders
(port of gslidar_tpu/parallel/).

* ``comm.py``: the communication seam. A ``ProcessGroup`` wraps a
  ``torch.distributed`` group (NCCL on the card, gloo on the CPU); a
  ``Loopback`` runs all n ranks in one process, as a virtual n-device
  mesh does for the JAX package, and is chosen only explicitly.
* ``shard.py``: the group's setup (``init_group``, ``make_mesh``) and
  the data-parallel train step (``make_parallel_train_step``).
* ``pano_shard.py``: the hfov-sliced, SH-sharded and gaussian-sharded
  single-frame 360° renders.

Each function is split at its collectives into per-rank stages; a group
calls the stages of the ranks it hosts (its own, or all n for the
loopback), so one card runs the same code that n cards would.
"""
