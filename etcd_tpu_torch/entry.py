"""Entry points of the port's flagship step.

``entry()`` returns ``(data_plane_step, args)`` with the example inputs
on CUDA: one fused round of WAL-chunk CRC chain verification and the
batched Raft leader pipeline over G co-hosted groups, as
``__graft_entry__.entry()`` does for the JAX package.
``dryrun_multichip(n)`` runs one full mesh-sharded step over ``n``
virtual shards of one device, as ``__graft_entry__.dryrun_multichip``
does over virtual CPU devices.

Run ``python -m etcd_tpu_torch.entry [N]`` to take one step and one
sharded step over N virtual shards (default 8) on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import default_device
from .crc import crc32c
from .ops.crc_device import u32_tensor
from .parallel import (
    data_plane_step,
    group_mesh,
    make_sharded_step,
    place_step_inputs,
)
from .raft.batched import LEADER, init_groups


def example_args(n=64, max_len=64, g=32, m=5, cap=32, seed_val=0xDEADBEEF,
                 device=None):
    """The step's inputs, made from a fixed seed exactly as the JAX
    package's ``_example_args`` makes them, on ``device`` (CUDA unless
    the caller asks for another).

    Returns ``(buf, lens, stored, seed, state, n_new, self_slot,
    resp_slots, resp_idx, resp_mask)``: ``n`` records of 1..``max_len``
    random bytes right-aligned in uint8 rows with their rolling CRC
    chain from ``seed_val``, and ``g`` groups of ``m`` members, each a
    leader at term 1 that appends 2 entries and hears 2 acks."""
    dev = default_device(device)
    rng = np.random.default_rng(0)
    lens = rng.integers(1, max_len + 1, size=n)
    buf = np.zeros((n, max_len), dtype=np.uint8)
    stored = np.empty(n, dtype=np.uint32)
    prev = seed_val
    for i, l in enumerate(lens):
        data = rng.integers(0, 256, size=l).astype(np.uint8).tobytes()
        buf[i, max_len - l:] = np.frombuffer(data, dtype=np.uint8)
        prev = crc32c.update(prev, data)
        stored[i] = prev

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (t(buf), t(lens.astype(np.int32)), u32_tensor(stored, dev),
            int(seed_val), *group_args(g, m, cap, dev))


def group_args(g, m, cap, device=None):
    """The Raft half of :func:`example_args`: ``(state, n_new,
    self_slot, resp_slots, resp_idx, resp_mask)`` for ``g`` groups of
    ``m`` members and ``cap`` log slots, each a leader at term 1 that
    appends 2 entries and hears acks at index 2 from slots 1 and 2."""
    dev = default_device(device)
    state = init_groups(g, m, cap, device=dev)
    state = state._replace(
        role=torch.full((g,), LEADER, dtype=torch.int32, device=dev),
        term=torch.ones((g,), dtype=torch.int32, device=dev))
    i32 = dict(dtype=torch.int32, device=dev)
    return (state, torch.full((g,), 2, **i32), torch.zeros((g,), **i32),
            torch.tensor([[1, 2]], **i32).repeat(g, 1),
            torch.full((g, 2), 2, **i32),
            torch.ones((g, 2), dtype=torch.bool, device=dev))


def entry():
    """``(fn, example_args)``: the single-card step and its inputs on
    CUDA.  Raises where CUDA is absent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return data_plane_step, example_args(device="cuda")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One full sharded step (``parallel.make_sharded_step``: raw CRCs
    of every (g, s) block XOR-combined over ``s``, the chain seam over
    ``g``, the commit frontier gathered) over a mesh of ``n_devices``
    virtual shards of ``default_device(device)`` (CUDA unless the caller
    asks for another), at the reference's tiny shapes, with its four
    checks.  Like the reference's run on virtual CPU devices, this
    checks the decomposition, not a multi-device speed."""
    dev = default_device(device)
    mesh = group_mesh(n_devices, devices=[dev] * n_devices)
    ng, ns = mesh.shape["g"], mesh.shape["s"]
    args = place_step_inputs(mesh, example_args(
        n=4 * ng, max_len=8 * ns, g=4 * ng, m=3, cap=16, device=dev))
    links_ok, _state, err, ncomm, commit_all = \
        make_sharded_step(mesh)(*args)
    assert all(bool(x.all()) for x in links_ok), "chain verify failed"
    assert not any(bool(x.any()) for x in err), "error lanes raised"
    assert commit_all.shape == (4 * ng,)
    assert all(bool((x == 2).all()) for x in ncomm), \
        "commit did not advance"


if __name__ == "__main__":
    import sys

    fn, args = entry()
    links_ok, state, err, ncomm = fn(*args)
    torch.cuda.synchronize()
    print("entry OK: links_ok all =", bool(links_ok.all()),
          "errors:", int(err.sum()),
          "committed:", ncomm[:4].tolist())
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dryrun_multichip(n)
    print(f"dryrun_multichip OK: {n} virtual shards of one card")
