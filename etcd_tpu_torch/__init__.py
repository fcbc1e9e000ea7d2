"""etcd-tpu's device data plane in PyTorch, for CUDA on NVIDIA Hopper.

The same layout and function names as ``etcd_tpu`` (the JAX package,
which stays the reference the port is held against), for the pieces
ported so far:

    crc/        CRC32-Castagnoli host digest and GF(2) algebra (copies)
    ops/        batched raw CRC (hand-written CUDA kernels + their plain
                torch versions), its variant formulations, chain
                verify, quorum commit index, the snapshot hash
                (``crc_kernel.py``)
    raft/       the single-group Raft state machine, log and node
                driver (``core.py``, ``log.py``, ``node.py``; copies),
                the [G]-batched Raft engine (``batched.py``), the
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
    server/     the classic single-group server (``server.py``:
                ``EtcdServer``, ``new_server``; ``config.py``,
                ``sender.py``), the front door every tier serves through
                (``frontdoor.py``), the co-hosted multi-group server
                (``multigroup.py``) and the distributed tier
                (``distserver.py`` with ``distpipe.py``, ``peerlink.py``,
                ``readindex.py``) and the role-split topology
                (``roles.py``, ``shmring.py``)
    api/        the HTTP client and peer API, the client library and
                the proxy (copies)
    discovery/  the discovery bootstrap (a copy)
    cli.py      ``python -m etcd_tpu_torch.cli``: the classic server by
                default, ``--cohosted-groups G``, ``--dist-slot N
                --dist-peers ...`` (either with ``--cohosted-mesh-devices``
                / ``--dist-mesh-devices``; ``--dist-roles S`` splits a dist
                host into supervised roles), ``--proxy``, ``--discovery``
    wire/       the protobuf records, requests and the dist tier's
                frames (copies)
    utils/      errors, fsync helpers, failpoints, backoff, the wait
                registry, the tracer, flags, TLS, the data dir's disk
                footprint (copies)
    obs/        roofline accounting, the metrics registry and its
                Prometheus text, the flight recorder, the device ledger,
                the time-series ring, the SLO verdict, the cross-role
                aggregator and the sampling profiler (with its owners
                table)
    native.py   ctypes binding of ``native/walscan.cc`` (built with g++
                at first use)
    scripts/    the raw-CRC variant race, the kernel sweep, the host
                WAL builder, the co-hosted, dist, config-5, classic and
                role phases of ``chip_smoke.py``, one dist host per
                process, the soak and the device-init probe
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
