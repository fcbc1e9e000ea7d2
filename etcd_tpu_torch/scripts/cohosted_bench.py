"""The co-hosted serving path at full width, phase by phase.

Four phases, each a function that ``chip_smoke.py`` (their only driver)
calls and holds:

- :func:`engine`: ``MultiRaft(g=100_000, m=5, cap=64)``, BASELINE config
  4 in the shape of the reference's ``bench.py:bench_group_latency``:
  ``campaign(0)``, one warm-up ``propose``, 8 timed ``propose(ones)``
  dispatches (p50 and max ms), then ``propose_rounds(ones, 22)``
  (ms/round, group-commits/s), then 4 dispatches under
  ``torch.profiler`` (device busy time, idle share, kernel launches per
  round).  Returns the final states, so that the same calls with
  ``device="cpu"`` can be held equal field for field.
- :func:`serving`: ``MultiGroupServer(g=10_000, m=5, cap=1024)``: the
  bootstrap election, then PUTs over distinct namespaces from client
  threads through ``do()`` (acked writes/s, p50/p99 ms), a profiled
  burst (launches and host syncs per round, idle share), every key read
  back, one CAS, one DELETE, one watch that fires, and the share of the
  WAL persist spent in the host CRC of its records.  It keeps the
  server's default ``snap_count``: at 10,000 groups the bootstrap's
  empty entries alone reach it, so a snapshot (store save, hash, WAL
  cut) lands inside the load and its stall inside the write latencies.
- :func:`write_restart_dir` and :func:`restart`: a data dir in the
  layout of the reference's ``bench.py:bench_restart`` (GroupEntry
  records over 10,000 groups, at least 8 MiB of WAL, chained with the
  native CRC; a snapshot whose store holds at least 4 MiB of keys), and
  one server construction on a copy of it per ``--storage-backend``.
- :func:`cli`: ``python -m etcd_tpu_torch.cli --cohosted-groups G`` as a
  subprocess: PUTs and GETs over HTTP, ``/v2/machines``, a kill by PID,
  and a restart on the same dir with ``--storage-backend tpu``.

Each phase takes ``device`` (CUDA unless the caller passes ``"cpu"``)
and its sizes, so the tests run them on the CPU at a small size.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import shutil
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from .. import default_device, native
from ..crc import crc32c
from ..obs.devledger import ledger
from ..obs.metrics import registry
from ..ops import crc_cuda
from ..ops.crc_kernel import auto_crc32c, device_hash_wins
from ..raft.batched import GroupState
from ..raft.multiraft import MultiRaft
from ..server.multigroup import MultiGroupServer
from ..server.server import DEFAULT_SNAP_COUNT
from ..snap import Snapshotter
from ..store import Store
from ..wal import WAL
from ..wal.backend_policy import get_policy
from ..wire import Entry, GroupEntry, HardState, Record, Snapshot
from ..wire.requests import Info, Request

REPO = Path(__file__).resolve().parents[2]


# -- the engine at config 4 -------------------------------------------------

def _states(mr: MultiRaft) -> list[dict]:
    return [{f: getattr(st, f).cpu().numpy() for f in GroupState._fields}
            for st in mr.states]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_calls(fn, reps: int, dev: torch.device) -> dict:
    """``reps`` calls of ``fn`` under ``torch.profiler``: wall and device
    busy ms per call, the idle share, and CUDA kernel launches per call
    (kernels only; copies and memsets counted apart).  Kernels that
    another thread launches are recorded only with ``TEARDOWN_CUPTI=1``
    in the environment, as ``chip_smoke.py`` sets it
    (``scripts/profiler_sessions.py``)."""
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    busy_us, kernels, copies = 0.0, 0, 0
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        busy_us += e.device_time
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
    wall_ms = wall * 1e3 / reps
    busy_ms = busy_us / 1e3 / reps
    top = sorted(((us / 1e3 / reps, n) for n, us in by_name.items()),
                 reverse=True)[:5]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "launches_per_call": kernels / reps,
            "copies_per_call": copies / reps, "top": top}


def engine(g: int = 100_000, m: int = 5, cap: int = 64, timed: int = 8,
           rounds: int = 22, profiled: int = 4, device=None) -> dict:
    """Config 4 in ``bench_group_latency``'s shape (module docstring).
    Raises if a dispatch commits other than one entry per group or the
    train other than ``rounds`` per group.  On the CPU the profiled
    dispatches run unprofiled (the same calls, so the states compare)."""
    dev = default_device(device)
    t0 = time.perf_counter()
    mr = MultiRaft(g=g, m=m, cap=cap, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    one = np.ones(g, np.int32)
    won = mr.campaign(0)
    if not won.all():
        raise RuntimeError("engine: the bootstrap campaign lost groups")
    mr.propose(one)  # warm-up
    lats = []
    for _ in range(timed):
        t0 = time.perf_counter()
        newly = mr.propose(one)   # returns host numpy: synced
        lats.append((time.perf_counter() - t0) * 1e3)
        if int(newly.sum()) != g:
            raise RuntimeError(f"engine: a dispatch committed "
                               f"{int(newly.sum())}, not {g}")
    mr.mark_applied(mr.commit_index())
    mr.compact()
    t0 = time.perf_counter()
    newly = mr.propose_rounds(one, rounds)
    train_s = time.perf_counter() - t0
    if int(newly.sum()) != g * rounds:
        raise RuntimeError(f"engine: the train committed "
                           f"{int(newly.sum())}, not {g * rounds}")
    if dev.type == "cuda":
        prof = profile_calls(lambda: mr.propose(one), profiled, dev)
    else:
        for _ in range(profiled):
            mr.propose(one)
        prof = None
    round_ms = train_s * 1e3 / rounds
    return {"g": g, "m": m, "cap": cap, "init_s": init_s,
            "dispatch_ms": lats, "p50_ms": statistics.median(lats),
            "max_ms": max(lats), "round_ms": round_ms,
            "group_commits_per_s": g / (round_ms / 1e3),
            "commit": mr.commit_index(), "profile": prof,
            "states": _states(mr), "leader": mr.leader.copy()}


def same_states(a: dict, b: dict) -> list[str]:
    """Fields (``slot.field``) where two engine results differ."""
    bad = [] if np.array_equal(a["leader"], b["leader"]) else ["leader"]
    for s, (x, y) in enumerate(zip(a["states"], b["states"])):
        bad += [f"{s}.{f}" for f in x
                if x[f].dtype != y[f].dtype or not np.array_equal(x[f], y[f])]
    return bad


# -- serving in process -------------------------------------------------------

def _stage_sum(stage: str) -> tuple[float, float]:
    h = registry.histogram("etcd_stage_seconds", stage=stage, kind="wall")
    return h.sum, h.count


def _ledger_totals() -> dict:
    snap = ledger.snapshot()
    return {"fetches": sum(v["fetches"] for v in snap.values()),
            "rounds": snap.get("multiraft.round", {}).get("dispatches", 0)}


#: the serving loop's traced stages (server/multigroup.py)
_STAGES = ("mg.consensus_round", "mg.persist", "mg.apply")


@contextlib.contextmanager
def _crc_inputs():
    """Collects every buffer the host CRC digests while open: the WAL
    encoder's records, across cuts (``Digest.write`` wrapped)."""
    seen: list = []
    write = crc32c.Digest.write

    def capture(self, data):
        seen.append(data)
        write(self, data)

    crc32c.Digest.write = capture
    try:
        yield seen
    finally:
        crc32c.Digest.write = write


def _crc_seconds(bufs: list) -> float:
    """Seconds the host CRC (``crc/crc32c.py``) takes to chain ``bufs``
    again, alone."""
    chain = 0
    t0 = time.perf_counter()
    for b in bufs:
        chain = crc32c.update(chain, b)
    return time.perf_counter() - t0


def _span(name: str) -> tuple[float, int]:
    h = registry.histogram("etcd_span_seconds", span=name)
    return h.sum, h.count


def _wal_bytes(d: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def _load(s: MultiGroupServer, keys: list[str], threads: int,
          timeout: float) -> tuple[float, list[float]]:
    """PUT ``keys`` (value = key) from ``threads`` client threads
    through ``do()``; returns (wall seconds, per-write ms)."""
    lats: list[float] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def client(part):
        for k in part:
            t0 = time.perf_counter()
            try:
                r = s.do(Request(id=int.from_bytes(os.urandom(7), "big") + 1,
                                 method="PUT", path=k, val=k),
                         timeout=timeout)
                if r.err is not None:
                    raise r.err
            except BaseException as e:  # reported by the caller
                with lock:
                    errors.append(e)
                return
            with lock:
                lats.append((time.perf_counter() - t0) * 1e3)

    ts = [threading.Thread(target=client, args=(keys[i::threads],))
          for i in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"serving: {len(errors)} writes failed, first: "
                           f"{errors[0]!r}")
    return wall, lats


def serving(g: int = 10_000, m: int = 5, cap: int = 1024,
            puts: int = 2000, threads: int = 8, profiled: int = 200,
            snap_count: int = DEFAULT_SNAP_COUNT, device=None,
            data_dir: str | None = None, timeout: float = 120.0) -> dict:
    """The in-process server at config 4's width (module docstring).
    Raises on any failed write, read-back, CAS, DELETE or watch, and on
    a profiled burst in which the profiler records no kernel."""
    dev = default_device(device)
    own = data_dir is None
    d = data_dir or tempfile.mkdtemp(prefix="cohosted_serving_")
    try:
        t0 = time.perf_counter()
        s = MultiGroupServer(d, g=g, m=m, cap=cap, device=dev,
                             snap_count=snap_count)
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        s.start()
        start_s = time.perf_counter() - t0
        try:
            state_bytes = sum(t.numel() * t.element_size()
                              for st in s.mr.states for t in st)
            keys = [f"/ns{i}/k" for i in range(puts)]
            stages0 = {st: _stage_sum(st) for st in _STAGES}
            snap0 = _span("mg.snapshot")
            with _crc_inputs() as crc_bufs:
                wall, lats = _load(s, keys, threads, timeout)
            snap1 = _span("mg.snapshot")
            stages1 = {st: _stage_sum(st) for st in _STAGES}
            crc_s = _crc_seconds(crc_bufs)
            lats.sort()

            # a profiled burst: launches and host syncs per round
            burst = [f"/burst{i}/k" for i in range(profiled)]
            tot0 = _ledger_totals()
            if dev.type == "cuda":
                prof = profile_calls(
                    lambda: _load(s, burst, threads, timeout), 1, dev)
            else:
                _load(s, burst, threads, timeout)
                prof = None
            tot1 = _ledger_totals()
            rounds = tot1["rounds"] - tot0["rounds"]
            if prof is not None:
                if not prof["launches_per_call"] or not rounds:
                    raise RuntimeError(
                        f"serving: the profiled burst recorded "
                        f"{prof['launches_per_call']} kernels over "
                        f"{rounds} rounds")
                prof["rounds"] = rounds
                prof["launches_per_round"] = \
                    prof["launches_per_call"] / rounds

            # every key reads back, after the snapshot's cut too; CAS,
            # DELETE and a watch
            for k in keys + burst:
                ev = s.do(Request(id=1 + len(k), method="GET", path=k)).event
                if ev.node.value != k:
                    raise RuntimeError(f"serving: {k} read back "
                                       f"{ev.node.value!r}")
            r = s.do(Request(id=11, method="PUT", path=keys[0], val="cas",
                             prev_value=keys[0]), timeout=timeout)
            if r.err is not None or r.event.action != "compareAndSwap":
                raise RuntimeError(f"serving: CAS failed: {r.err!r}")
            r = s.do(Request(id=12, method="DELETE", path=keys[1]),
                     timeout=timeout)
            if r.err is not None or r.event.action != "delete":
                raise RuntimeError(f"serving: DELETE failed: {r.err!r}")
            wc = s.do(Request(id=13, method="GET", path="/watched/k",
                              wait=True)).watcher
            s.do(Request(id=14, method="PUT", path="/watched/k", val="w"),
                 timeout=timeout)
            ev = wc.next_event(timeout=timeout)
            if ev is None or ev.action != "set" or ev.node.value != "w":
                raise RuntimeError("serving: the watch did not fire")
        finally:
            s.stop()
        spent = {st: stages1[st][0] - stages0[st][0] for st in _STAGES}
        persist_s = spent["mg.persist"]
        return {
            "g": g, "m": m, "cap": cap, "puts": puts, "threads": threads,
            "snap_count": snap_count, "init_s": init_s, "start_s": start_s,
            "state_bytes": state_bytes, "load_s": wall,
            "acked_writes_per_s": puts / wall,
            "p50_ms": lats[len(lats) // 2],
            "p99_ms": lats[min(len(lats) - 1, int(len(lats) * 0.99))],
            "max_ms": lats[-1],
            "snapshots": snap1[1] - snap0[1],
            "snapshot_s": snap1[0] - snap0[0],
            "rounds": stages1["mg.persist"][1] - stages0["mg.persist"][1],
            "round_stage_s": spent["mg.consensus_round"],
            "apply_s": spent["mg.apply"], "persist_s": persist_s,
            "other_s": wall - sum(spent.values()),
            "crc_bytes": sum(len(b) for b in crc_bufs), "wal_crc_s": crc_s,
            "wal_crc_share_of_persist": crc_s / persist_s if persist_s else
            None, "crc_fast_path": crc32c._gcrc is not None,
            "syncs_per_round": (tot1["fetches"] - tot0["fetches"]) / rounds
            if rounds else None,
            "profile": prof}
    finally:
        if own:
            shutil.rmtree(d, ignore_errors=True)


# -- restart through the kernel ---------------------------------------------

def _server_id(name: str) -> int:
    return int.from_bytes(hashlib.sha1(name.encode()).digest()[:8],
                          "big") & (2**63 - 1)


def write_restart_dir(d: str, g: int = 10_000, k_per: int = 20,
                      window: int = 10_000, snap_keys: int = 24_000,
                      value_len: int = 160, name: str = "multigroup") -> dict:
    """A data dir in ``bench_restart``'s layout: ``g * k_per``
    GroupEntry records (``k_per`` per group, term 1) after the seq-0
    zero-frontier marker, then the frontier; a snapshot covering all
    but the last ``window // g`` entries of every group, whose store
    holds ``snap_keys`` keys of ``value_len``-byte values.  Entries
    past the snapshot PUT distinct window keys.  Records are chained
    with ``native.crc32c_update`` (the port's WAL encoder chains with
    the host CRC, pure Python without ``google_crc32c``)."""
    os.makedirs(os.path.join(d, "snap"))
    waldir = os.path.join(d, "wal")
    w = WAL.create(waldir, Info(id=_server_id(name)).marshal())
    zero = np.zeros(g, np.int32).tobytes()
    w.save(HardState(), [Entry(index=0, term=0, data=GroupEntry(
        kind=1, payload=zero + zero).marshal())])
    chain = w.encoder.crc.sum32()
    path = w._fpath
    w.close()
    snap_k = max(0, k_per - max(1, window // g))
    pool = [Request(method="PUT", id=i + 1, path=f"/ns{i}/k",
                    val="v").marshal() for i in range(64)]
    out = bytearray()
    window_keys = []
    seq = 0
    for idx in range(1, k_per + 1):
        for gi in range(g):
            seq += 1
            if idx > snap_k:
                key = f"/win{gi}/k{idx}"
                window_keys.append(key)
                payload = Request(method="PUT", id=seq, path=key,
                                  val=f"w{seq}").marshal()
            else:
                payload = pool[seq % 64]
            ent = Entry(index=seq, term=1, data=GroupEntry(
                kind=0, group=gi, gindex=idx, gterm=1,
                payload=payload).marshal()).marshal()
            chain = native.crc32c_update(chain, ent)
            rec = Record(type=2, crc=chain, data=ent).marshal()
            out += struct.pack("<q", len(rec)) + rec
    seq += 1
    frontier = np.full(g, k_per, np.int32).tobytes() + \
        np.ones(g, np.int32).tobytes()
    ent = Entry(index=seq, term=1, data=GroupEntry(
        kind=1, payload=frontier).marshal()).marshal()
    chain = native.crc32c_update(chain, ent)
    rec = Record(type=2, crc=chain, data=ent).marshal()
    out += struct.pack("<q", len(rec)) + rec
    with open(path, "ab") as f:
        f.write(out)
    w = WAL.open_at_end(waldir, Info(id=_server_id(name)).marshal(), chain,
                        seq)
    w.save_state(HardState(term=1, vote=0, commit=seq))
    w.close()

    snap_seq = snap_k * g
    store = Store()
    val = "x" * value_len
    for i in range(snap_keys):
        store.set(f"/snap{i % 97}/k{i}", False, val, None)
    blob = json.dumps({
        "store": store.save().decode(), "frontier": [snap_k] * g,
        "terms": [1] * g, "seq": snap_seq, "applied_total": snap_seq,
    }).encode()
    Snapshotter(os.path.join(d, "snap"),
                crc_fn=lambda b: native.crc32c_update(0, b)).save_snap(
        Snapshot(data=blob, index=snap_seq, term=1))
    return {"records": seq + 1, "wal_bytes": _wal_bytes(waldir),
            "snap_bytes": len(blob), "window_keys": window_keys,
            "snap_key_sample": [f"/snap{i % 97}/k{i}"
                                for i in range(0, snap_keys, 997)]}


def reset_launches() -> None:
    crc_cuda.raw_crc_cuda.launches = 0
    crc_cuda.raw_crc_cuda.launches_by = dict.fromkeys(
        crc_cuda.raw_crc_cuda.launches_by, 0)


def restart(src: str, backend: str, g: int = 10_000, m: int = 5,
            device=None, records: int | None = None) -> dict:
    """Construct ``MultiGroupServer`` on a copy of ``src`` with
    ``storage_backend=backend`` (construction IS the restart): seconds,
    records/s, the lane the router took, raw-CRC kernel launches, and
    the restarted server's index, frontier and store bytes."""
    dev = default_device(device)
    d = tempfile.mkdtemp(prefix=f"cohosted_restart_{backend}_")
    try:
        dst = os.path.join(d, "data")
        shutil.copytree(src, dst)
        get_policy().decisions.pop("restart", None)
        _sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        s = MultiGroupServer(dst, g=g, m=m, storage_backend=backend,
                             device=dev)
        _sync(dev)
        secs = time.perf_counter() - t0
        launches = crc_cuda.raw_crc_cuda.launches
        try:
            decision = get_policy().decisions.get("restart")
            out = {"backend": backend, "seconds": secs,
                   "records_per_s": (records or 0) / secs,
                   "lane": decision["route"] if decision else "host",
                   "why": decision["why"] if decision else
                   "--storage-backend host", "launches": launches,
                   "device_hash_wins": device_hash_wins(),
                   "raft_index": s.raft_index,
                   "frontier": s.applied.copy(),
                   "store": s.store.save(), "server": s}
        finally:
            s.stop()
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def snapshot_load(src: str, device=None) -> dict:
    """``Snapshotter.load`` of ``src``'s snapshot through
    ``auto_crc32c`` on ``device`` alone: seconds, kernel launches and
    the outcome of ``auto_crc32c``'s one-time race (None before it has
    run; the race's own launches count in the call that runs it)."""
    dev = default_device(device)
    ss = Snapshotter(os.path.join(src, "snap"),
                     crc_fn=functools.partial(auto_crc32c, device=dev))
    _sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    snap = ss.load()
    _sync(dev)
    return {"seconds": time.perf_counter() - t0,
            "launches": crc_cuda.raw_crc_cuda.launches,
            "bytes": len(snap.data), "device_hash_wins": device_hash_wins()}


# -- the normal entry point ---------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http(method: str, url: str, body: bytes | None = None):
    req = urllib.request.Request(url, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", "application/x-www-form-urlencoded")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _spawn(args: list[str], env: dict, port: int, deadline_s: float):
    proc = subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch.cli", *args], cwd=REPO,
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < deadline_s:
        if proc.poll() is not None:
            raise RuntimeError(f"cli exited {proc.returncode}: "
                               f"{proc.stderr.read()[-3000:]}")
        try:
            socket.create_connection(("127.0.0.1", port), 0.2).close()
            return proc, time.perf_counter() - t0
        except OSError:
            time.sleep(0.05)
    _kill(proc)
    raise RuntimeError("cli never listened")


def _kill(proc) -> int:
    os.kill(proc.pid, signal.SIGKILL)
    rc = proc.wait(timeout=60)
    proc.stderr.close()
    return rc


def cli(g: int = 10_000, m: int = 5, keys: int = 8, device: str | None = None,
        deadline_s: float = 600.0) -> dict:
    """The CLI as a subprocess (module docstring).  ``device`` is passed
    as ``ETCD_TORCH_DEVICE`` (unset: CUDA).  Raises on any failed
    response, a CLI that does not listen, or one that survives its
    kill."""
    d = tempfile.mkdtemp(prefix="cohosted_cli_")
    env = dict(os.environ)
    env.pop("ETCD_TORCH_DEVICE", None)
    if device is not None:
        env["ETCD_TORCH_DEVICE"] = device
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    common = ["--cohosted-groups", str(g), "--cohosted-members", str(m),
              "--frontdoor", "off", "--data-dir", os.path.join(d, "data"),
              "--listen-client-urls", base, "--advertise-client-urls", base]
    try:
        proc, up_s = _spawn(common, env, port, deadline_s)
        try:
            lats = []
            for i in range(keys):
                t0 = time.perf_counter()
                st, body = _http("PUT", f"{base}/v2/keys/cli{i}/k",
                                 f"value=v{i}".encode())
                lats.append((time.perf_counter() - t0) * 1e3)
                if st not in (200, 201) or \
                        json.loads(body)["node"]["value"] != f"v{i}":
                    raise RuntimeError(f"cli: PUT {i} answered {st} {body!r}")
            for i in range(keys):
                st, body = _http("GET", f"{base}/v2/keys/cli{i}/k")
                if st != 200 or json.loads(body)["node"]["value"] != f"v{i}":
                    raise RuntimeError(f"cli: GET {i} answered {st} {body!r}")
            st, body = _http("GET", f"{base}/v2/machines")
            if st != 200 or base not in body.decode():
                raise RuntimeError(f"cli: /v2/machines answered {st} "
                                   f"{body!r}")
        finally:
            rc1 = _kill(proc)
        if rc1 != -signal.SIGKILL:
            raise RuntimeError(f"cli: exit {rc1} after SIGKILL")
        proc, up2_s = _spawn(common + ["--storage-backend", "tpu"], env,
                             port, deadline_s)
        try:
            for i in range(keys):
                st, body = _http("GET", f"{base}/v2/keys/cli{i}/k")
                if st != 200 or json.loads(body)["node"]["value"] != f"v{i}":
                    raise RuntimeError(f"cli restart: GET {i} answered {st} "
                                       f"{body!r}")
        finally:
            rc2 = _kill(proc)
        if rc2 != -signal.SIGKILL:
            raise RuntimeError(f"cli: exit {rc2} after SIGKILL")
        return {"g": g, "m": m, "listen_s": up_s, "restart_listen_s": up2_s,
                "put_ms": lats, "keys": keys, "exit_codes": [rc1, rc2]}
    finally:
        shutil.rmtree(d, ignore_errors=True)
