"""The fused single-card data-plane step (the port of the unsharded half
of ``etcd_tpu/parallel/mesh.py``)."""

from .mesh import data_plane_step, replay_commit_local

__all__ = ["data_plane_step", "replay_commit_local"]
