"""etcd-tpu's device data plane in PyTorch, for CUDA on NVIDIA Hopper.

The same layout and function names as ``etcd_tpu`` (the JAX package,
which stays the reference the port is held against), for the pieces
ported so far:

    crc/        CRC32-Castagnoli host digest and GF(2) algebra (copies)
    ops/        batched raw CRC (hand-written CUDA kernels + their plain
                torch versions), its variant formulations, chain
                verify, quorum commit index, the snapshot hash
                (``crc_kernel.py``)
    raft/       the [G]-batched Raft engine (``batched.py``), the
                co-hosted G x M runtime on it (``multiraft.py``) and one
                host's member slot of G groups (``distmember.py``)
    parallel/   the fused single-card data-plane step, and its
                mesh-sharded form over a (g, s) grid of devices (which
                may be virtual shards of one card)
    wal/        the WAL (``wal.py``), its replay lanes on the card
                (``replay_device.py``) and their router
                (``backend_policy.py``)
    snap/       the snapshotter and the streamed-snapshot chunk
                verifier
    store/      the hierarchical KV store with TTLs and watches (copy)
    server/     the co-hosted multi-group server (``multigroup.py``),
                the distributed tier (``distserver.py`` with
                ``distpipe.py``, ``peerlink.py``, ``readindex.py``) and
                the seams they share (``server.py``)
    api/        the HTTP client API
    cli.py      ``python -m etcd_tpu_torch.cli --cohosted-groups G`` or
                ``--dist-slot N --dist-peers ...``, either with
                ``--cohosted-mesh-devices`` / ``--dist-mesh-devices``
    wire/       the protobuf records, requests and the dist tier's
                frames (copies)
    utils/      errors, fsync helpers, failpoints, backoff, the wait
                registry, the tracer, flags, TLS (copies)
    obs/        roofline accounting, a metrics registry, the device
                ledger
    native.py   ctypes binding of ``native/walscan.cc`` (built with g++
                at first use)
    scripts/    the raw-CRC variant race, the kernel sweep, the host
                WAL builder, the co-hosted, dist and config-5 phases
                of ``chip_smoke.py``, one dist host per process
    entry.py    example inputs, the entry point of that step and the
                sharded dry run
    csrc/       CUDA C++ sources, built with nvcc at first use

The package imports neither ``jax`` nor ``etcd_tpu``.  Entry points run
on CUDA unless the caller asks for the CPU (the tests do); without CUDA
they raise rather than fall back.
"""

from __future__ import annotations

import torch

__version__ = "0.5.0-alpha+cuda"


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device``
    names another.  Raises if CUDA was meant and is absent: a run on
    the CPU is only ever one the caller asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "etcd_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run the plain torch versions on the CPU")
    return dev
