"""The classic single-group server's phases of ``chip_smoke.py`` (phase
15): the default etcd process (``python -m etcd_tpu_torch.cli`` with the
reference's defaults) on the card.

Sizes.  The source is the etcd v0.5 README ("benchmarked 1000s of
writes/s per instance") and the reference's defaults: a snapshot every
``--snapshot-count`` 10,000 committed entries (server.go:29), three
members, no proxy in the write path; entries carry BASELINE config 1's
256-byte values.

- :func:`write_restart_dir`: a classic data dir as a member leaves it
  after ``keys`` writes and a snapshot: a ``Snapshotter`` snapshot of a
  ``Store`` holding ``keys`` keys of ``VALUE_LEN``-byte values over
  ``dirs`` first-level directories at raft index ``keys`` (at the
  default 100,000 keys about 35 MB of JSON), and a WAL tail of ``tail``
  PUTs of new keys after it (one default ``--snapshot-count``), its
  records chained with ``native.crc32c_update``.
- :func:`restart`: ``new_server`` on a copy of it under one
  ``--storage-backend`` (``cohosted_bench.timed_restart``: construction
  is the restart, the snapshot load, hashed by ``auto_crc32c``, and the
  WAL replay), then the
  committed tail applied from the first ``Ready``: seconds, the lane,
  raw-CRC kernel launches, the hard state, the log's last index and
  term, and the store.  :func:`replay_alone` and
  ``cohosted_bench.snapshot_load`` time the two halves alone.
- :func:`cluster`: three CLI processes with the reference's defaults on
  loopback (CUDA unless ``device`` names another), every one started
  with ``ETCD_FRONTDOOR_TENANTS`` = ``HOT_TENANT`` (the tenant ``hot``
  gets 50 writes/s): ``puts`` PUTs of ``VALUE_LEN``-byte values from
  ``conns`` keep-alive
  connections to the leader over ``namespaces`` namespaces (the default
  snapshot falls under the load at 12,000), every acked key read back
  from every member; a burst of PUTs on ``hot`` shed with 429 while the
  other namespaces' writes are acked, ``/metrics``, ``/v2/stats/
  frontdoor``, ``/v2/machines`` and a long-poll watch through the front
  door; ``--proxy on`` and ``--proxy readonly`` over the three client
  URLs; a follower SIGKILLed, ``extra`` more PUTs acked by the other
  two, and the follower restarted with ``--storage-backend tpu``,
  catching up and reading every key back.  A PUT the server answered
  "request timed out" is retried, as etcd's clients do, and counted.

Each phase takes ``device`` and its sizes, so the tests run them on the
CPU at a small size; the widths (``VALUE_LEN``, ``HOT_TENANT``) and the
seed are fixed.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import struct
import sys
import tempfile
import threading
import time
import urllib.parse

import numpy as np

from .. import default_device, native
from ..ops import crc_cuda
from ..server import Cluster, ServerConfig, new_server
from ..server.server import _replay_wal_raw
from ..snap import Snapshotter
from ..store import Store
from ..wal import WAL
from ..wire import ENTRY_NORMAL, Entry, HardState, Record, Snapshot
from ..wire.requests import Info, Request
from .cohosted_bench import (REPO, _sync, free_ports, kill, log_tail,
                             reset_launches, start_cli, timed_restart,
                             wait_listen)

NAME = "c0"
PEER_URL = "http://127.0.0.1:7001"
#: BASELINE config 1's value width
VALUE_LEN = 256
#: ``ETCD_FRONTDOOR_TENANTS`` for every member: the tenant ``hot`` gets
#: 50 writes/s, a burst of 50 and 8 in flight
HOT_TENANT = "hot=50,50,8"
SEED = 0
#: seconds any one wait of the cluster phase may take
DEADLINE_S = 300.0


def config(d: str, backend: str) -> ServerConfig:
    """The one-member cluster the restart dir was written for."""
    c = Cluster()
    c.set_from_string(f"{NAME}={PEER_URL}")
    return ServerConfig(name=NAME, data_dir=d, cluster=c,
                        client_urls=["http://127.0.0.1:4001"],
                        storage_backend=backend)


def _value(rng, n: int) -> str:
    return rng.bytes(n // 2).hex()


def write_restart_dir(d: str, keys: int = 100_000, dirs: int = 64,
                      tail: int = 10_000) -> dict:
    """The data dir of the module docstring.  Returns its sizes and the
    keys it holds (snapshot keys, then tail keys)."""
    rng = np.random.default_rng(SEED)
    member = config(d, "host").cluster.find_name(NAME)
    md = Info(id=member.id).marshal()
    snapdir, waldir = os.path.join(d, "snap"), os.path.join(d, "wal")
    os.makedirs(snapdir)
    st = Store()
    snap_keys = [f"/ns{i % dirs}/k{i}" for i in range(keys)]
    for k in snap_keys:
        st.set(k, False, _value(rng, VALUE_LEN), None)
    blob = st.save()
    del st
    Snapshotter(snapdir, crc_fn=lambda b: native.crc32c_update(0, b)
                ).save_snap(Snapshot(data=blob, index=keys, term=1,
                                     nodes=[member.id]))
    w = WAL.create(waldir, md)
    chain, path = w.encoder.crc.sum32(), w._fpath
    w.close()
    # the entry at the snapshot's index heads the replayed log (the raft
    # log's first slot), then the tail of new keys
    tail_keys = [f"/ns{i % dirs}/t{i}" for i in range(tail)]
    payloads = [Request(method="PUT", id=keys, path=snap_keys[-1],
                        val="head").marshal()]
    payloads += [Request(method="PUT", id=keys + 1 + i, path=k,
                         val=_value(rng, VALUE_LEN)).marshal()
                 for i, k in enumerate(tail_keys)]
    out = bytearray()
    for i, data in enumerate(payloads):
        ent = Entry(term=1, index=keys + i, data=data).marshal()
        chain = native.crc32c_update(chain, ent)
        rec = Record(type=2, crc=chain, data=ent).marshal()
        out += struct.pack("<q", len(rec)) + rec
    with open(path, "ab") as f:
        f.write(out)
    last = keys + tail
    w = WAL.open_at_end(waldir, md, chain, last)
    w.save_state(HardState(term=1, vote=member.id, commit=last))
    w.close()
    return {"keys": snap_keys + tail_keys, "snap_bytes": len(blob),
            "wal_bytes": sum(os.path.getsize(os.path.join(waldir, f))
                             for f in os.listdir(waldir)),
            "last_index": last, "records": len(payloads)}


def restart(src: str, backend: str, device=None) -> dict:
    """``new_server`` on a copy of ``src`` under ``backend``, then the
    committed tail applied from the first ``Ready`` (module docstring).
    The returned ``server`` is stopped; its store stays readable."""
    dev = default_device(device)
    with timed_restart(src, backend, dev, lambda d: new_server(
            config(d, backend), device=dev)) as (s, out):
        try:
            lg = s.node.r.raft_log
            out.update(hard_state=s.node.r.hard_state().marshal(),
                       last=(lg.last_index(), lg.term(lg.last_index())))
            t0 = time.perf_counter()
            rd = s.node.ready(timeout=0)
            applied = 0
            with s.store.fanout_round():
                for e in rd.committed_entries:
                    if e.type == ENTRY_NORMAL:
                        r = s.apply_request(Request.unmarshal(e.data))
                        if r.err is not None:
                            raise RuntimeError(f"restart: entry {e.index} "
                                               f"failed to apply: {r.err}")
                        applied += 1
            out.update(apply_s=time.perf_counter() - t0, applied=applied,
                       store=s.store.save(), server=s)
        finally:
            s.stop()
            s.storage.wal.close()
    return out


def replay_alone(src: str, backend: str, index: int, device=None) -> dict:
    """``_replay_wal_raw`` alone on a copy of ``src``'s WAL: seconds,
    launches and the largest batch the kernel took."""
    dev = default_device(device)
    d = tempfile.mkdtemp(prefix="classic_replay_")
    try:
        shutil.copytree(os.path.join(src, "wal"), os.path.join(d, "wal"))
        _sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        w, _, _, ents = _replay_wal_raw(os.path.join(d, "wal"), index,
                                        backend, device=dev)
        _sync(dev)
        secs = time.perf_counter() - t0
        w.close()
        return {"seconds": secs, "entries": len(ents),
                "launches": crc_cuda.raw_crc_cuda.launches,
                "largest": list(crc_cuda.raw_crc_cuda.largest)}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def flip_in_record(src_wal: str) -> int:
    """Flip the last byte of the record halfway through the WAL's last
    segment (inside its entry data, so neither the framing nor the
    torn-tail repair sees it).  Returns the offset."""
    path = os.path.join(src_wal, sorted(os.listdir(src_wal))[-1])
    buf = bytearray(open(path, "rb").read())
    target, off = len(buf) // 2, 0
    while off < len(buf):
        n = struct.unpack_from("<q", buf, off)[0]
        if off + 8 + n >= target:
            pos = off + 8 + n - 1
            buf[pos] ^= 0x01
            with open(path, "wb") as f:
                f.write(buf)
            return pos
        off += 8 + n
    raise ValueError("no record past the target")


# -- the three-member CLI cluster --------------------------------------------


class _Conn:
    """One keep-alive HTTP connection, re-dialed after an error."""

    def __init__(self, base: str, timeout: float = 60.0):
        u = urllib.parse.urlsplit(base)
        self.host, self.port, self.timeout = u.hostname, u.port, timeout
        self.c = None

    def request(self, method: str, path: str, body: bytes | None = None):
        for attempt in (0, 1):
            if self.c is None:
                self.c = http.client.HTTPConnection(self.host, self.port,
                                                    timeout=self.timeout)
            try:
                h = {"Content-Type": "application/x-www-form-urlencoded"} \
                    if body is not None else {}
                self.c.request(method, path, body=body, headers=h)
                r = self.c.getresponse()
                return r.status, dict(r.getheaders()), r.read()
            except (OSError, http.client.HTTPException):
                self.c.close()
                self.c = None
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def close(self) -> None:
        if self.c is not None:
            self.c.close()


def _req(base: str, method: str, path: str, body: bytes | None = None,
         timeout: float = 60.0):
    c = _Conn(base, timeout)
    try:
        return c.request(method, path, body)
    finally:
        c.close()


class Member:
    """One CLI member process: its name, URLs, data dir and log."""

    def __init__(self, tmp: str, name: str, peer_port: int,
                 client_port: int):
        self.name, self.tmp = name, tmp
        self.peer = f"http://127.0.0.1:{peer_port}"
        self.client = f"http://127.0.0.1:{client_port}"
        self.client_port = client_port
        self.data = os.path.join(tmp, name)
        self.log = os.path.join(tmp, f"{name}.log")
        self.proc = None

    def start(self, initial_cluster: str, env: dict, *extra) -> None:
        self.t_spawn = time.perf_counter()
        self.proc = start_cli(
            ["--name", self.name, "--initial-cluster", initial_cluster,
             "--data-dir", self.data, "--listen-peer-urls", self.peer,
             "--advertise-peer-urls", self.peer,
             "--listen-client-urls", self.client,
             "--advertise-client-urls", self.client, *extra], env, self.log)

    def wait_listen(self) -> float:
        """Seconds from the spawn until the client URL accepts."""
        return wait_listen(self.proc, self.client_port, DEADLINE_S,
                           self.log, self.t_spawn)

    def kill(self) -> int:
        return 0 if self.proc is None else kill(self.proc)


def _leader(members: list[Member]) -> Member:
    deadline = time.time() + DEADLINE_S
    while time.time() < deadline:
        for m in members:
            try:
                st, _, body = _req(m.client, "GET", "/v2/stats/self",
                                   timeout=5)
                if st == 200 and json.loads(body)["state"] == "StateLeader":
                    return m
            except (OSError, http.client.HTTPException):
                pass
        time.sleep(0.2)
    raise RuntimeError("no leader elected")


def _etcd_index(base: str) -> int:
    st, h, _ = _req(base, "GET", "/v2/keys/")
    return int(h["X-Etcd-Index"])


#: seconds a client keeps retrying a PUT the server answered "request
#: timed out" (500, errorCode 300, after the reference's 0.5 s server
#: timeout): the proposal may still commit, and etcd's clients retry
#: it; a PUT is a set, so a retry is idempotent.  The snapshot, taken
#: inside the apply loop as in the reference, pauses the leader's loop
#: past that timeout (PERF.md, section 7).
PUT_DEADLINE_S = 60.0


def _load(base: str, items: list[tuple[str, str]], conns: int) -> dict:
    """PUT every ``(key, value)`` from ``conns`` keep-alive connections:
    acked keys, per-PUT latencies (first attempt to ack, retries of a
    timed-out PUT included), retries, refusals and wall seconds."""
    lat, acked, refused = [], [], []
    retries = [0]
    lock = threading.Lock()
    parts = [items[i::conns] for i in range(conns)]

    def put(c, k, v):
        t0 = time.perf_counter()
        while True:
            st, _, body = c.request("PUT", f"/v2/keys{k}",
                                    f"value={v}".encode())
            if st in (200, 201):
                return (time.perf_counter() - t0) * 1e3, None
            if st != 500 or b"timed out" not in body \
                    or time.perf_counter() - t0 > PUT_DEADLINE_S:
                return None, (k, st, body[:200])
            with lock:
                retries[0] += 1

    def worker(part):
        c = _Conn(base)
        try:
            for k, v in part:
                try:
                    ms, bad = put(c, k, v)
                except (OSError, http.client.HTTPException) as e:
                    ms, bad = None, (k, None, repr(e))
                with lock:
                    if bad is None:
                        lat.append(ms)
                        acked.append(k)
                    else:
                        refused.append(bad)
        finally:
            c.close()

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(p,)) for p in parts]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    secs = time.perf_counter() - t0
    lat.sort()
    return {"acked": acked, "refused": refused, "seconds": secs,
            "retries": retries[0], "acked_writes_per_s": len(acked) / secs,
            "p50_ms": lat[len(lat) // 2] if lat else None,
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))]
            if lat else None,
            "max_ms": lat[-1] if lat else None}


def _values_under(base: str, namespaces: list[str]) -> dict[str, str]:
    out = {}
    for ns in namespaces:
        st, _, body = _req(base, "GET", f"/v2/keys/{ns}?recursive=true")
        if st == 404:
            continue
        if st != 200:
            raise RuntimeError(f"{base}: GET /{ns} answered {st}")
        for n in json.loads(body)["node"].get("nodes", []):
            out[n["key"]] = n.get("value")
    return out


def _caught_up(members: list[Member], target: int) -> float:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < DEADLINE_S:
        if all(_etcd_index(m.client) >= target for m in members):
            return time.perf_counter() - t0
        time.sleep(0.1)
    raise RuntimeError(f"members never reached index {target}")


def _read_back(members: list[Member], want: dict[str, str],
               namespaces: list[str]) -> int:
    for m in members:
        got = _values_under(m.client, namespaces)
        missing = [k for k, v in want.items() if got.get(k) != v]
        if missing:
            raise RuntimeError(f"{m.name}: {len(missing)} acked keys lost "
                               f"or wrong, e.g. {missing[:3]}")
    return len(want)


def cluster(puts: int = 12_000, conns: int = 16, namespaces: int = 64,
            burst: int = 500, extra: int = 1_000,
            snapshot_count: int | None = None, device: str | None = None,
            tmp: str | None = None) -> dict:
    """Phases (b)-(e) of the module docstring.  ``device`` is passed as
    ``ETCD_TORCH_DEVICE`` (unset: CUDA); ``snapshot_count``, when given,
    as ``--snapshot-count`` (unset: the reference's 10,000).  Raises on
    any failed gate; stops every process it started."""
    rng = np.random.default_rng(SEED)
    own_tmp = tmp is None
    tmp = tmp or tempfile.mkdtemp(prefix="classic_cluster_")
    env = dict(os.environ)
    env.pop("ETCD_TORCH_DEVICE", None)
    env.pop("ETCD_FRONTDOOR", None)
    if device is not None:
        env["ETCD_TORCH_DEVICE"] = device
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["ETCD_FRONTDOOR_TENANTS"] = HOT_TENANT
    ports = free_ports(6)
    members = [Member(tmp, f"n{i}", ports[2 * i], ports[2 * i + 1])
               for i in range(3)]
    ic = ",".join(f"{m.name}={m.peer}" for m in members)
    flags = [] if snapshot_count is None else \
        ["--snapshot-count", str(snapshot_count)]
    proxies = []
    out: dict = {"puts": puts, "conns": conns, "namespaces": namespaces}
    try:
        # (b) three members, the reference's defaults
        for m in members:
            m.start(ic, env, *flags)
        out["listen_s"] = [m.wait_listen() for m in members]
        lead = _leader(members)
        ns = [f"ns{i}" for i in range(namespaces)]
        items = [(f"/{ns[i % namespaces]}/k{i}", _value(rng, VALUE_LEN))
                 for i in range(puts)]
        load = _load(lead.client, items, conns)
        if load["refused"]:
            raise RuntimeError(f"load: {len(load['refused'])} PUTs refused, "
                               f"e.g. {load['refused'][:2]}")
        want = dict(items)
        target = _etcd_index(lead.client)
        out["catch_up_s"] = _caught_up(members, target)
        out["read_back"] = _read_back(members, want, ns)
        snaps = os.listdir(os.path.join(lead.data, "snap"))
        if not snaps:
            raise RuntimeError("no snapshot in the leader's snap dir")
        out["leader_snapshots"] = len(snaps)
        st, _, spans = _req(lead.client, "GET", "/v2/stats/spans")
        spans = json.loads(spans)
        out["leader_spans"] = {k: spans[k] for k in (
            "server.persist", "server.send", "server.apply",
            "server.snapshot") if k in spans}
        out["load"] = {k: v for k, v in load.items()
                       if k not in ("acked", "refused")}
        out["load"]["acked"] = len(load["acked"])

        # (c) admission through the front door: a burst on "hot" sheds
        # while the other namespaces' writes are all acked
        hot_items = [(f"/hot/b{i}", "x") for i in range(burst)]
        other_items = [(f"/{ns[i % namespaces]}/o{i}", _value(rng, 16))
                       for i in range(max(64, burst // 4))]
        shed, results = [], {}

        def hot_worker(part):
            c = _Conn(lead.client)
            try:
                for k, v in part:
                    st, h, body = c.request("PUT", f"/v2/keys{k}",
                                            f"value={v}".encode())
                    if st == 429:
                        shed.append((json.loads(body)["errorCode"],
                                     h.get("Retry-After")))
            finally:
                c.close()

        def other_worker():
            results["other"] = _load(lead.client, other_items, 4)

        ts = [threading.Thread(target=hot_worker, args=(hot_items[i::8],))
              for i in range(8)]
        ts.append(threading.Thread(target=other_worker))
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if not shed or any(code != 406 or not ra for code, ra in shed):
            raise RuntimeError(f"burst on hot: {len(shed)} sheds, "
                               f"{shed[:3]}")
        if results["other"]["refused"]:
            raise RuntimeError(f"other namespaces refused during the "
                               f"burst: {results['other']['refused'][:3]}")
        want.update(other_items)
        st, _, metrics = _req(lead.client, "GET", "/metrics")
        shed_total = 0.0
        for line in metrics.decode().splitlines():
            if line.startswith('etcd_admission_total{outcome="shed_write"'):
                shed_total += float(line.rsplit(" ", 1)[1])
        if st != 200 or shed_total <= 0:
            raise RuntimeError(f"/metrics: {st}, shed_write {shed_total}")
        st, _, fd = _req(lead.client, "GET", "/v2/stats/frontdoor")
        if st != 200 or "admission" not in json.loads(fd):
            raise RuntimeError(f"/v2/stats/frontdoor answered {st}")
        st, _, mach = _req(lead.client, "GET", "/v2/machines")
        if st != 200 or not all(m.client in mach.decode() for m in members):
            raise RuntimeError(f"/v2/machines answered {st} {mach!r}")
        watched = {}

        def watch():
            watched["r"] = _req(lead.client, "GET",
                                "/v2/keys/watch/k?wait=true", timeout=60)

        wt = threading.Thread(target=watch)
        wt.start()
        time.sleep(0.5)
        if _req(lead.client, "PUT", "/v2/keys/watch/k",
                b"value=seen")[0] not in (200, 201):
            raise RuntimeError("watch PUT refused")
        wt.join(60)
        if wt.is_alive() or watched["r"][0] != 200 or \
                json.loads(watched["r"][2])["node"]["value"] != "seen":
            raise RuntimeError(f"the watch did not see the PUT: {watched}")
        want["/watch/k"] = "seen"
        out["admission"] = {
            "burst": burst, "shed": len(shed),
            "shed_write_total": shed_total,
            "other_acked": len(results["other"]["acked"]),
            "retry_after": sorted({ra for _, ra in shed})}

        # (d) the proxy over the three client URLs
        pc = ",".join(f"{m.name}={m.client}" for m in members)
        for mode in ("on", "readonly"):
            # a port picked now: one picked before the load may since
            # have gone to one of its client connections
            port = free_ports(1)[0]
            url = f"http://127.0.0.1:{port}"
            plog = os.path.join(tmp, f"proxy_{mode}.log")
            p = start_cli(["--proxy", mode, "--initial-cluster", pc,
                           "--listen-client-urls", url], env, plog)
            proxies.append(p)
            wait_listen(p, port, DEADLINE_S, plog)
            st, _, _ = _req(url, "PUT", f"/v2/keys/proxy/{mode}",
                            b"value=via")
            if (mode == "on") != (st in (200, 201)) or \
                    (mode == "readonly" and st != 501):
                raise RuntimeError(f"--proxy {mode}: PUT answered {st}")
            if mode == "on":
                want[f"/proxy/{mode}"] = "via"
                st, _, body = _req(url, "GET", "/v2/keys/proxy/on")
                if st != 200 or json.loads(body)["node"]["value"] != "via":
                    raise RuntimeError(f"--proxy on: GET answered {st}")
        out["proxy"] = {"on": "PUT and GET passed",
                        "readonly": "PUT answered 501"}

        # (e) a follower killed, more PUTs on the quorum of two, the
        # follower restarted with --storage-backend tpu
        follower = next(m for m in members if m is not lead)
        out["killed"] = follower.name
        follower.kill()
        more = [(f"/{ns[i % namespaces]}/e{i}", _value(rng, VALUE_LEN))
                for i in range(extra)]
        load2 = _load(lead.client, more, conns)
        if load2["refused"]:
            raise RuntimeError(f"one member down: {len(load2['refused'])} "
                               f"PUTs refused")
        want.update(more)
        target = _etcd_index(lead.client)
        follower.start(ic, env, *flags, "--storage-backend", "tpu")
        out["restart_listen_s"] = follower.wait_listen()
        _caught_up([follower], target)
        out["restart_catch_up_s"] = time.perf_counter() - follower.t_spawn
        lanes = [ln for ln in log_tail(follower.log, 200_000).splitlines()
                 if "-route replay of" in ln]
        out["restart_replay"] = lanes[-1].split(": ", 1)[-1] if lanes \
            else "no fast-lane replay logged"
        out["load_one_down"] = {k: v for k, v in load2.items()
                                if k not in ("acked", "refused")}
        out["load_one_down"]["acked"] = len(load2["acked"])
        out["read_back_after_restart"] = _read_back(
            members, want, ns + ["hot", "watch", "proxy"])
        return out
    except Exception:
        for m in members:
            if os.path.exists(m.log):
                print(f"--- {m.name} log tail ---\n{log_tail(m.log)}",
                      file=sys.stderr)
        raise
    finally:
        for p in proxies:
            kill(p)
        for m in members:
            m.kill()
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)
