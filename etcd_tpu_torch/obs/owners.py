"""Thread-ownership domains of the port: the owner roots the sampling
profiler (``obs/profiler.py``) attributes each sampled stack to.

A domain is a piece of state that one thread or process root writes
by convention (the front door's per-connection state, the shm ring's
cursors, the ingest lanes' index slots, the append pipeline's per-peer
bookkeeping).  Each domain lists its owner roots as ``(relpath,
scope)`` function keys: a thread target or a role main.  The profiler
walks a sampled stack outward for the first frame whose (file
basename, function name) is such a root, so a profile row says which
domain's owner thread the sample ran under.

The table is data: the same domains and roots as the JAX package's
``etcd_tpu/analysis/ownership.py`` ``DOMAINS``, with the port's paths.
The port keeps the reference's file basenames and function names, so
the profiler's ``(basename, last scope component)`` keys are the
same in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Domain:
    """One ownership domain: the roots allowed to write it, and the
    lock (``Class.attr``) under which another root may touch it."""

    owners: tuple[tuple[str, str], ...]  # (relpath, scope) roots
    doc: str = ""
    guard: str | None = None


DOMAINS: dict[str, Domain] = {
    "frontdoor-loop": Domain(
        owners=(
            ("etcd_tpu_torch/server/frontdoor.py", "FrontDoor._run"),
        ),
        doc=("per-connection state (_Conn fields, conn/timer "
             "tables): written only by the frontdoor event-loop "
             "thread; workers hand results back via the _post "
             "mailbox")),
    "shmring-producer": Domain(
        owners=(
            ("etcd_tpu_torch/server/distserver.py", "DistServer.run"),
            ("etcd_tpu_torch/server/distserver.py",
             "_make_peer_handler.Handler.do_POST"),
        ),
        doc=("ring head/generation cursors: the serving shard's "
             "apply path publishes, every producer-side touch "
             "serialized by the server lock"),
        guard="DistServer.lock"),
    "shmring-consumer": Domain(
        owners=(
            ("etcd_tpu_torch/server/roles.py", "run_worker.consume"),
        ),
        doc="ring tail cursor: only the worker consume thread pops"),
    "ingest-lanes": Domain(
        owners=(
            ("etcd_tpu_torch/server/roles.py", "RemoteEtcd._lane"),
        ),
        doc=("per-lane etcd_index high-water slots: each written "
             "only by its own lane thread (slot-striped, no lock); "
             "everyone else reads max()")),
    "distpipe-state": Domain(
        owners=(
            ("etcd_tpu_torch/server/distserver.py", "DistServer.run"),
            ("etcd_tpu_torch/server/distserver.py",
             "_make_peer_handler.Handler.do_POST"),
        ),
        doc=("append-pipeline per-peer bookkeeping: mutated from "
             "the run loop, the frame handler and the peerlink "
             "channel threads' ack/fail callbacks, every touch under "
             "the owning server's lock"),
        guard="DistServer.lock"),
}

__all__ = ["DOMAINS", "Domain"]
