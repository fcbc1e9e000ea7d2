"""Raft consensus on the card: ``batched`` is the [G, ...]-batched engine
and ``multiraft`` the co-hosted G-groups x M-members runtime on it (the
port of ``etcd_tpu/raft/batched.py`` and ``multiraft.py``)."""
