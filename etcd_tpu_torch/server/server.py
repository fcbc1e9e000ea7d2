"""The serving seams the co-hosted server shares with the single-group
server (the port's copy of the part of ``etcd_tpu/server/server.py``
that ``multigroup.py`` imports): ``Response``, ``apply_request_to_store``,
``gen_id``, the two server errors, ``DEFAULT_SNAP_COUNT`` and the
restart replay ``_replay_wal_raw``.  The classic single-group
``EtcdServer`` (and ``_replay_wal``, its entry-list form) is not ported
yet.

``_replay_wal_raw`` differs from the reference in three ways:

- ``--storage-backend=tpu`` keeps its promise without the router's
  ``strict_device`` flag: it replays on the ``stream`` lane (unless the
  ``ETCD_REPLAY_BACKEND`` override names another), recorded as the
  router would record it.
- Only a crash-torn tail (:class:`TornTailError`, never acked) goes to
  the host repair path, on every backend; any other failure of a lane
  raises instead of falling back to the host, so a failed kernel is
  never hidden.
- ``device`` is passed through to the replay lanes and the router's
  probe (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import logging
import os
import random
from dataclasses import dataclass
from typing import Optional

from ..store import Store, Watcher
from ..utils.errors import EtcdError
from ..utils.trace import tracer
from ..wal import WAL, TornTailError
from ..wal.backend_policy import DEVICE_MIN_BYTES, get_policy
from ..wire.requests import Request

log = logging.getLogger(__name__)

DEFAULT_SNAP_COUNT = 10000  # reference server.go:29


class UnknownMethodError(Exception):
    pass


class ServerStoppedError(Exception):
    pass


def gen_id() -> int:
    """Random nonzero 63-bit id (reference server.go:575-580)."""
    n = 0
    while n == 0:
        n = random.getrandbits(63)
    return n


@dataclass
class Response:
    """Reference server.go:45-49."""

    event: object | None = None
    watcher: Optional[Watcher] = None
    err: Exception | None = None


def apply_request_to_store(store: Store, r: Request) -> Response:
    """Map a committed Request onto a store call (reference
    server.go:503-540)."""
    expr = r.expiration / 1e9 if r.expiration else None

    def f(call):
        try:
            return Response(event=call())
        except EtcdError as e:
            return Response(err=e)

    if r.method == "POST":
        return f(lambda: store.create(r.path, r.dir, r.val, True, expr))
    if r.method == "PUT":
        exists, exists_set = r.prev_exist, r.prev_exist is not None
        if exists_set:
            if exists:
                return f(lambda: store.update(r.path, r.val, expr))
            return f(lambda: store.create(r.path, r.dir, r.val, False,
                                          expr))
        if r.prev_index > 0 or r.prev_value != "":
            return f(lambda: store.compare_and_swap(
                r.path, r.prev_value, r.prev_index, r.val, expr))
        return f(lambda: store.set(r.path, r.dir, r.val, expr))
    if r.method == "DELETE":
        if r.prev_index > 0 or r.prev_value != "":
            return f(lambda: store.compare_and_delete(
                r.path, r.prev_value, r.prev_index))
        return f(lambda: store.delete(r.path, r.dir, r.recursive))
    if r.method == "QGET":
        # through-the-log quorum read: counted at apply
        store.stats.inc_read_path("quorum")
        return f(lambda: store.get(r.path, r.recursive, r.sorted))
    if r.method == "SYNC":
        store.delete_expired_keys(r.time / 1e9)
        return Response()
    return Response(err=UnknownMethodError(r.method))


def _replay_wal_raw(waldir: str, index: int, backend: str,
                    stage: str = "restart", device=None):
    """WAL replay honoring --storage-backend (``host`` | ``tpu`` |
    ``auto``) through the measured router (``wal/backend_policy``), the
    decision recorded under ``stage``.

    - ``host``: the host path (``WAL.read_all`` with torn-tail repair).
    - ``tpu``: the ``stream`` lane on ``device`` (the raw-CRC kernel on
      the card), or the lane ``ETCD_REPLAY_BACKEND`` names.
    - ``auto``: the router's lane; below ``DEVICE_MIN_BYTES`` it answers
      ``host`` without touching the device, and the native host scan
      runs when the library loaded.

    The fast lanes return entries as an un-materialized ``EntryBlock``
    (struct-of-arrays, the form ``gereplay.scan`` feeds on); the
    repair-capable host path returns an Entry list.  A crash-torn tail
    (``TornTailError``) on a fast lane goes to the host repair path,
    which truncates it; any other failure raises.
    """
    if backend != "host":
        from .. import native
        from ..wal.replay_device import open_replay_device

        size = sum(os.path.getsize(os.path.join(waldir, f))
                   for f in os.listdir(waldir))
        pol = get_policy()
        if backend == "tpu":
            route, why = pol._env_route()
            if route is None:
                route, why = "stream", "strict_device"
            pol.note(stage, route, why, size_bytes=size)
        else:
            route = pol.route(stage, size_bytes=size, device=device)
        env_forced = pol.decisions[stage]["why"].startswith("env ")
        # the native host scan beats the pure-Python decoder at every
        # size; the device lanes keep the amortization threshold unless
        # the operator's override or the tpu backend demands them
        use_fast = (backend == "tpu" or env_forced
                    or size >= DEVICE_MIN_BYTES
                    or (route == "host" and native.available()))
        if use_fast:
            try:
                with tracer.span("replay.device"):
                    w, md, hard_state, block = open_replay_device(
                        waldir, index, route=route, device=device)
                log.info("etcdserver: %s-route replay of %d entries "
                         "(%d bytes)", route, len(block), size)
                return w, md, hard_state, block
            except TornTailError:
                # a crash-torn tail must heal on EVERY backend: the torn
                # bytes were never acked (acks only follow fsync)
                log.warning("etcdserver: %s-route replay found a torn "
                            "tail; host repair path", route)
                pol.note(stage, "host", f"{route} lane failed "
                         f"(TornTailError); host repair path")
    with tracer.span("replay.host"):
        w = WAL.open_at_index(waldir, index)
        md, hard_state, ents = w.read_all(repair=True)
    return w, md, hard_state, ents

