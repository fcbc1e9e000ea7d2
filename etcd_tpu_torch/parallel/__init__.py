"""Mesh sharding of group-sharded consensus state (the port of
``etcd_tpu/parallel``): the fused single-card data-plane step, and its
mesh-sharded form over a ``(g, s)`` grid of devices, which may be
virtual shards of one card (BASELINE config 5)."""

from .mesh import (
    BlockLayout,
    GroupMesh,
    check_group_divisible,
    data_plane_step,
    group_mesh,
    leading_placer,
    local_devices,
    make_replay_commit_step,
    make_sharded_step,
    place_step_inputs,
    replay_commit_local,
    shard_grid,
    shard_leading,
)

__all__ = [
    "BlockLayout",
    "GroupMesh",
    "data_plane_step",
    "check_group_divisible",
    "group_mesh",
    "leading_placer",
    "local_devices",
    "make_replay_commit_step",
    "make_sharded_step",
    "place_step_inputs",
    "replay_commit_local",
    "shard_grid",
    "shard_leading",
]
