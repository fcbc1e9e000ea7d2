"""Raft consensus on the card: ``batched`` is the [G, ...]-batched engine
(the port of ``etcd_tpu/raft/batched.py``)."""
