"""The distributed tier on the port: cluster helpers and a 3-process run.

Two kinds of cluster:

- in process (:func:`make_dist_cluster`, :func:`bootstrap_dist_leader`):
  M ``DistServer`` objects on localhost HTTP, the port's copy of the
  reference tests' helpers (``tests/conftest.py``);
- three processes (:func:`spawn_node`, :func:`run`): ``python -m
  etcd_tpu_torch.scripts.dist_node`` per member slot, each with its own
  engine on its own device context.

:func:`run` is the dist phase of ``chip_smoke.py``, shaped like the
reference's ``scripts/dist_bench.py`` client: ``total`` proposals over
``POST /mraft/propose_many`` (keep-alive HTTP) from ``conns``
connections, each keeping a window of ``window`` writes in flight, all
sent to host 0 (the bootstrap leader), keys spread over 8 x G
namespaces so every group takes writes.  Then:

1. every acked write is read back from all three hosts, once each host
   has applied up to the leader's applied frontier (the leader applies
   only what a quorum of fsynced acks committed);
2. slot 2 is SIGKILLed and ``extra`` more proposals commit on the
   remaining quorum of 2;
3. slot 2 restarts with ``--storage-backend tpu`` (its WAL replays on
   the stream lane, through the raw-CRC kernel on a CUDA device), must
   catch up, and every key must read back from it.

It returns the client's acked writes/s and ack p50/p99, and per host the
entries it applied per second of the load, the server's
``etcd_ack_rtt_seconds`` p50/p99, its rounds (leader rounds
that shipped frames plus append frames handled) and its host reads of
device state per round (``obs.devledger`` fetches of the ``dist.*``
stages), with the restart's seconds, lane and raw-CRC launches.

The row also carries the windowed rates and the worst-of SLO verdict off
the nodes' time-series rings (:func:`fetch_windowed`, :func:`fetch_slo`).

Two more runs, as the reference's bench has them:

- :func:`run_roles_once` (``--roles S``): the same load against the
  role-split topology, three hosts each a supervisor with an ingest, a
  worker and S shards (:class:`RoleCluster`, :func:`spawn_roles`),
  through host 0's ingest; the row adds the per-role CPU split, the
  handoff stages' share and the supervisors' merged windowed rates and
  SLO verdict.  ``scripts/roles_bench.py`` drives the same cluster
  through its crash drills for ``chip_smoke.py``;
- :func:`run_profile_overhead` (``--profile-overhead``): the load alone
  (:func:`run_load_once`) with the sampling profiler on and off
  (``ETCD_PROFILE_HZ=0``), both arms' acked writes/s.

    python -m etcd_tpu_torch.scripts.dist_bench [--groups G] [--total N]
        [--roles S | --profile-overhead]

runs one and prints the result as one JSON line; the nodes run on CUDA
unless ``ETCD_TORCH_DEVICE`` names another device.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

from ..server.distserver import pack_requests
from ..server.multigroup import group_of
from ..wire.requests import Request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# -- in-process clusters ----------------------------------------------------


def free_ports(n: int) -> list[int]:
    """Reserve n distinct localhost ports (bind/close)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def make_dist_cluster(tmp_path, m=3, g=8, ports=None, **kw):
    """Start m DistServers on localhost HTTP.  election=60 ticks (3 s):
    a shared test host pushes round latency past the production
    0.5-1 s window; the protocol is what's under test, not the timing
    margin."""
    from ..server.distserver import DistServer

    ports = ports or free_ports(m)
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    kw.setdefault("cap", 64)
    kw.setdefault("tick_interval", 0.05)
    kw.setdefault("post_timeout", 2.0)
    kw.setdefault("election", 60)
    servers = []
    for s in range(m):
        srv = DistServer(str(tmp_path / f"d{s}"), slot=s,
                         peer_urls=urls, g=g, **kw)
        srv.start()
        servers.append(srv)
    return servers, ports


def bootstrap_dist_leader(servers, timeout=30.0) -> None:
    """Converge host 0 onto leadership of every group (re-campaign
    lanes lost to peer-timer races)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        lead = servers[0].mr.is_leader()
        if lead.all():
            return
        servers[0]._campaign(~lead)
        time.sleep(0.3)
    raise AssertionError("bootstrap election did not converge")


# -- node processes ---------------------------------------------------------


def spawn_node(tmp: str, slot: int, urls: list[str], *, groups: int,
               cap: int = 64, depth: int = 8, max_batch_ents: int = 32,
               backend: str = "auto", bootstrap: bool = False,
               env_extra: dict | None = None) -> subprocess.Popen:
    """One ``dist_node`` process for member ``slot``; its stderr goes
    to ``<tmp>/node<slot>.log``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if env_extra:
        env.update(env_extra)
    cmd = [sys.executable, "-m", "etcd_tpu_torch.scripts.dist_node",
           "--data-dir", os.path.join(tmp, f"d{slot}"),
           "--slot", str(slot), "--peers", ",".join(urls),
           "--groups", str(groups), "--cap", str(cap),
           "--max-batch-ents", str(max_batch_ents),
           "--pipeline-depth", str(depth),
           "--storage-backend", backend]
    if bootstrap:
        cmd.append("--bootstrap")
    err = open(os.path.join(tmp, f"node{slot}.log"), "ab")
    try:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                                env=env, cwd=REPO, text=True)
    finally:
        err.close()


def wait_ready(proc: subprocess.Popen, timeout: float = 180.0) -> dict:
    """Read the node's JSON line, then wait for READY; returns the JSON
    line.  Raises when the node dies or the deadline passes."""
    info: dict = {}
    out: list[str] = []

    def reader():
        for line in proc.stdout:
            out.append(line)
            if line.strip() == "READY":
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout)
    for line in out:
        if line.startswith("{"):
            info = json.loads(line)
    if not out or out[-1].strip() != "READY":
        raise AssertionError(
            f"node never became READY (rc={proc.poll()}): {out[-3:]}")
    return info


def stop_nodes(procs) -> None:
    """SIGTERM every live node, then SIGKILL what is still up after
    10 s."""
    for p in procs:
        if p is not None and p.poll() is None:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
    for p in procs:
        if p is None:
            continue
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


# -- client -----------------------------------------------------------------


def propose_many(conn: http.client.HTTPConnection,
                 reqs: list[Request]) -> tuple[list[bool], list[str]]:
    """One ``/mraft/propose_many`` POST; per request, whether it was
    acked, and the messages of the requests that were not."""
    conn.request("POST", "/mraft/propose_many", body=pack_requests(reqs),
                 headers={"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    out = json.loads(resp.read().decode())
    ok = [True] * len(reqs)
    for i in out.get("errs", {}):
        ok[int(i)] = False
    return ok, [e.get("message", "") for e in out.get("errs", {}).values()]


def _get_json(url: str, path: str, timeout: float = 30.0):
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return json.loads(r.read().decode())


def store_values(url: str) -> dict[str, str]:
    """Every leaf key of host ``url``'s store replica: path -> value."""
    blob = _get_json(url, "/mraft/snapshot", timeout=120.0)
    out: dict[str, str] = {}

    def walk(node):
        if node.get("Children") is not None:
            for child in node["Children"].values():
                walk(child)
        else:
            out[node["Path"]] = node.get("Value")

    walk(json.loads(blob["store"])["Root"])
    return out


def applied_frontier(url: str) -> np.ndarray:
    """[G] applied index of host ``url``."""
    return np.asarray(_get_json(url, "/mraft/snapshot/frontier")
                      ["frontier"], np.int64)


def wait_applied(urls: list[str], target: np.ndarray,
                 timeout: float) -> float:
    """Wait until every host's applied frontier reaches ``target``;
    returns the seconds waited."""
    t0 = time.perf_counter()
    left = list(urls)
    while left:
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{left} never applied up to the "
                                 f"leader's frontier")
        left = [u for u in left
                if not (applied_frontier(u) >= target).all()]
        if left:
            time.sleep(0.2)
    return time.perf_counter() - t0


def host_stats(url: str) -> dict:
    """The server-side numbers of one host, off ``/mraft/obs``."""
    reg = _get_json(url, "/mraft/obs")

    def samples(name):
        return reg.get(name, {}).get("samples", [])

    def by_stage(name):
        return {s["labels"]["stage"]: s["value"] for s in samples(name)}

    rtt = [s for s in samples("etcd_ack_rtt_seconds") if s["count"]]
    counts = {n: sum(s["value"] for s in samples(n)) for n in (
        "etcd_election_campaigns_total", "etcd_election_wins_total")}
    lead = np.asarray(_get_json(url, "/mraft/leaders")["lead"], bool)
    fetches = by_stage("etcd_devledger_fetches_total")
    dispatches = by_stage("etcd_devledger_dispatches_total")
    rounds = int(dispatches.get("dist.build_append", 0)
                 + dispatches.get("dist.handle_append", 0))
    reads = int(sum(v for k, v in fetches.items() if k.startswith("dist.")))
    return {
        "ack_rtt_p50_ms": rtt[0]["p50"] * 1e3 if rtt else None,
        "ack_rtt_p99_ms": rtt[0]["p99"] * 1e3 if rtt else None,
        "ack_rtt_count": rtt[0]["count"] if rtt else 0,
        "leader_rounds": int(dispatches.get("dist.build_append", 0)),
        "frames_handled": int(dispatches.get("dist.handle_append", 0)),
        "snapshot_installs": {s["labels"]["outcome"]: int(s["value"])
                              for s in samples("etcd_snap_install_total")},
        "campaign_lanes": int(counts["etcd_election_campaigns_total"]),
        "won_lanes": int(counts["etcd_election_wins_total"]),
        "lanes_led": int(lead.sum()),
        "odd_lanes_led": int(lead[1::2].sum()),
        "rounds": rounds, "device_reads": reads,
        "reads_per_round": reads / rounds if rounds else None,
        "reads_by_stage": {k: int(v) for k, v in fetches.items()
                           if k.startswith("dist.")},
    }


def load(url: str, keys: list[str], conns: int, window: int,
         deadline_s: float) -> dict:
    """PUT ``keys`` (value = key) through ``conns`` keep-alive
    connections, each a window of ``window`` writes per batch.  Returns
    the acked keys, the per-write batch RTTs and the wall seconds."""
    host, port = url.split("//")[1].split(":")
    parts = [keys[t::conns] for t in range(conns)]
    acked: list[list[str]] = [[] for _ in range(conns)]
    lats: list[tuple[float, int]] = []
    refused: dict[str, int] = {}
    lock = threading.Lock()
    errors: list[BaseException] = []
    t_end = time.perf_counter() + deadline_s

    def client(t):
        try:
            c = http.client.HTTPConnection(host, int(port), timeout=120)
            for lo in range(0, len(parts[t]), window):
                if time.perf_counter() > t_end:
                    break
                chunk = parts[t][lo:lo + window]
                reqs = [Request(method="PUT", id=(t << 40) | (lo + j + 1)
                                | (hash(k) & 0xFFFF) << 24,
                                path=k, val=k)
                        for j, k in enumerate(chunk)]
                t0 = time.perf_counter()
                ok, msgs = propose_many(c, reqs)
                rtt = time.perf_counter() - t0
                done = [k for k, o in zip(chunk, ok) if o]
                acked[t].extend(done)
                with lock:
                    lats.append((rtt, len(done)))
                    for m in msgs:
                        refused[m] = refused.get(m, 0) + 1
                if not done:
                    time.sleep(0.05)  # leader not ready: back off
            c.close()
        except BaseException as e:  # surfaced after the join
            errors.append(e)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(t,)) for t in range(conns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    seconds = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return {"acked": [k for a in acked for k in a], "lats": lats,
            "seconds": seconds, "refused": refused}


def warm_up(url: str, key: str, attempts: int = 60) -> None:
    """The warm-up write (value = key), re-sent with a new id until a
    leader acks it, as a client would; raises after ``attempts``."""
    host, port = url.split("//")[1].split(":")
    c = http.client.HTTPConnection(host, int(port), timeout=180)
    try:
        for attempt in range(attempts):
            try:
                ok, msgs = propose_many(c, [Request(
                    method="PUT", id=(1 << 50) + attempt, path=key,
                    val=key)])
            except (OSError, http.client.HTTPException) as e:
                c.close()  # reconnects on the next request
                ok, msgs = [False], [repr(e)]
            if ok[0]:
                return
            time.sleep(0.5)
    finally:
        c.close()
    raise AssertionError(f"the warm-up write was refused: {msgs}")


def weighted_pct(pairs: list[tuple[float, int]], q: float) -> float:
    """The q-quantile of per-write latency, each batch's RTT weighted by
    the writes it acked."""
    pairs = sorted(p for p in pairs if p[1])
    total = sum(n for _, n in pairs)
    if not total:
        return 0.0
    acc = 0
    for v, n in pairs:
        acc += n
        if acc >= q * total:
            return v
    return pairs[-1][0]


def _load_row(r: dict, proposed: int) -> dict:
    a = r["acked"]
    return {"proposals": proposed, "acked": len(a),
            "refused": r["refused"], "seconds": r["seconds"],
            "acked_writes_per_s": len(a) / r["seconds"],
            "ack_p50_ms": weighted_pct(r["lats"], 0.5) * 1e3,
            "ack_p99_ms": weighted_pct(r["lats"], 0.99) * 1e3}


def require_keys(urls: list[str], keys: list[str], groups: int,
                 when: str) -> None:
    """Raise unless every host holds every key of ``keys``, each with
    itself as its value.  The error names each host's missing count,
    for a few missing keys their group's applied index and leader on
    every host, and each host's snapshot installs."""
    from ..server.multigroup import group_of

    missing = {}
    for u in urls:
        vals = store_values(u)
        missing[u] = [k for k in keys if vals.get(k) != k]
    if not any(missing.values()):
        return
    frontiers = [applied_frontier(u) for u in urls]
    leads = [np.asarray(_get_json(u, "/mraft/leaders")["lead"], bool)
             for u in urls]
    detail = []
    for k in next(m for m in missing.values() if m)[:4]:
        gi = group_of(k, groups)
        detail.append((k, gi, [int(f[gi]) for f in frontiers],
                       [bool(ld[gi]) for ld in leads]))
    installs = [{s["labels"]["outcome"]: s["value"] for s in
                 _get_json(u, "/mraft/obs").get(
                     "etcd_snap_install_total", {}).get("samples", [])}
                for u in urls]
    raise AssertionError(
        f"{when}: missing acked keys by host "
        f"{[len(missing[u]) for u in urls]}; (key, group, applied by "
        f"host, leads by host): {detail}; snapshot installs by host: "
        f"{installs}")


# -- the observability plane --------------------------------------------------


def fetch_stage_stats(urls: list[str], timeout: float = 5) -> dict:
    """Per-stage wall/CPU/device attribution off ``/mraft/obs`` (the
    ``etcd_stage_seconds`` families the stage() facade feeds), summed
    over ``urls``: which stage is eating the serving core."""
    agg: dict[str, dict[str, float]] = {}
    for u in urls:
        try:
            with urllib.request.urlopen(u + "/mraft/obs",
                                        timeout=timeout) as r:
                snap = json.loads(r.read())
        except Exception:
            continue
        for s in snap.get("etcd_stage_seconds",
                          {}).get("samples", []):
            stage = s["labels"].get("stage", "?")
            kind = s["labels"].get("kind", "?")
            row = agg.setdefault(stage, {"wall_s": 0.0, "cpu_s": 0.0,
                                         "device_s": 0.0,
                                         "passes": 0})
            if kind == "wall":
                row["wall_s"] += s.get("sum", 0.0)
                row["passes"] += s.get("count", 0)
            elif kind == "cpu":
                row["cpu_s"] += s.get("sum", 0.0)
            elif kind == "device":
                row["device_s"] += s.get("sum", 0.0)
    out = {}
    for stage, row in sorted(agg.items(),
                             key=lambda kv: -kv[1]["cpu_s"]):
        out[stage] = {"wall_s": round(row["wall_s"], 3),
                      "cpu_s": round(row["cpu_s"], 3),
                      "device_s": round(row["device_s"], 3),
                      "passes": int(row["passes"])}
    return out


def fetch_windowed(urls: list[str], timeout: float = 5) -> dict | None:
    """Windowed rates off every node's time-series ring: GET
    /mraft/obs/timeseries per node, pooled by the pure snapshot
    helpers — acked/s and read/s over the LAST 10 s and windowed RTT
    p99s over the last 60 s, not lifetime averages.  A node that
    fails to answer is simply absent from the pool."""
    from ..obs import timeseries

    snaps = []
    for u in urls:
        try:
            with urllib.request.urlopen(u + "/mraft/obs/timeseries",
                                        timeout=timeout) as r:
                snaps.append(json.loads(r.read()))
        except Exception:
            continue
    if not snaps:
        return None
    return timeseries.windowed_summary(snaps)


def fetch_slo(urls: list[str], timeout: float = 5) -> dict | None:
    """Worst-of SLO verdict across the cluster: each node evaluates
    its own objectives over its ring (GET /mraft/obs/slo); the bench
    merges to the worst verdict and keeps the per-objective burn
    rates — the one-line answer to 'is this run inside its error
    budget'."""
    from ..obs import slo

    verdicts = []
    for u in urls:
        try:
            with urllib.request.urlopen(u + "/mraft/obs/slo",
                                        timeout=timeout) as r:
                verdicts.append(json.loads(r.read()))
        except Exception:
            continue
    if not verdicts:
        return None
    merged = slo.merge_verdicts(verdicts)
    return {
        "verdict": merged["verdict"],
        "worst": merged.get("worst"),
        "burn_rates": {
            name: round(o.get("burn_rate", 0.0), 3)
            for name, o in merged.get("objectives", {}).items()
            if o.get("burn_rate") is not None},
    }


@contextlib.contextmanager
def node_cluster(groups: int, cap: int, depth: int, max_batch_ents: int,
                 env_extra: dict | None = None, tmp: str | None = None):
    """Three ``dist_node`` processes on free ports, slot 0 bootstrapping
    every group's leadership, all READY.  Yields ``(tmp, urls, procs,
    infos)``: ``procs`` is the live list, so a caller that replaces a
    process leaves the replacement to be stopped on exit; ``infos`` are
    the nodes' JSON lines, by slot."""
    own_tmp = tmp is None
    tmp = tmp or tempfile.mkdtemp(prefix="dist_bench_")
    urls = [f"http://127.0.0.1:{p}" for p in free_ports(3)]
    procs: list = [None, None, None]
    try:
        procs[:] = [spawn_node(tmp, s, urls, groups=groups, cap=cap,
                               depth=depth, max_batch_ents=max_batch_ents,
                               bootstrap=(s == 0), env_extra=env_extra)
                    for s in range(3)]
        # followers first: slot 0's READY waits on its bootstrap
        infos = {s: wait_ready(procs[s], timeout=300.0) for s in (1, 2, 0)}
        yield tmp, urls, procs, [infos[s] for s in range(3)]
    finally:
        stop_nodes(procs)
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def run(groups: int = 10_000, cap: int = 1024, total: int = 16_000,
        conns: int = 8, window: int = 512, extra: int = 2_000,
        depth: int = 8, max_batch_ents: int = 128,
        load_deadline_s: float = 180.0, settle_s: float = 240.0,
        env_extra: dict | None = None, tmp: str | None = None) -> dict:
    """The 3-process run described in the module docstring."""
    ns = 8 * groups
    names = [f"/b{i % ns}/k{i}" for i in range(total + extra + 1)]
    warm, first, second = names[0], names[1:total + 1], names[total + 1:]
    out: dict = {"groups": groups, "cap": cap, "hosts": 3,
                 "conns": conns, "window": window,
                 "pipeline_depth": depth, "max_batch_ents": max_batch_ents,
                 "namespaces": ns,
                 "state_bytes_per_host": groups * cap * 4
                 + groups * (10 * 4 + 3 * (4 + 4 + 1))}
    t0 = time.perf_counter()
    with node_cluster(groups, cap, depth, max_batch_ents, env_extra,
                      tmp) as (tmp, urls, procs, infos):
        out["start_s"] = time.perf_counter() - t0
        out["device"] = infos[1].get("device")
        warm_up(urls[0], warm)

        # 1. the load, then every acked write read back from all hosts.
        # A write refused (its lane had no leader on host 0) is not
        # acked and is not re-sent, as in the reference's client
        # every host caught up first (a follower applies the
        # bootstrap's entries on later frames), so each host's applied
        # count below grows by the load's entries alone
        wait_applied(urls, applied_frontier(urls[0]), settle_s)
        applied0 = [int(applied_frontier(u).sum()) for u in urls]
        r1 = load(urls[0], first, conns, window, load_deadline_s)
        applied1 = [int(applied_frontier(u).sum()) for u in urls]
        a1 = r1["acked"]
        out["load"] = _load_row(r1, len(first))
        if not a1:
            raise AssertionError(f"no write acked; refusals: "
                                 f"{r1['refused']}")
        target = applied_frontier(urls[0])
        out["settle_s"] = wait_applied(urls, target, settle_s)
        require_keys(urls, a1 + [warm], groups, "after the load")
        out["hosts_stats"] = [host_stats(u) for u in urls]
        # windowed truth: last-10 s / 60 s rates and the SLO verdict
        # off the nodes' time-series rings
        out["windowed"] = fetch_windowed(urls)
        out["slo"] = fetch_slo(urls)
        for h, n0, n1 in zip(out["hosts_stats"], applied0, applied1):
            # entries this host applied while the clients ran (the
            # writes and a few SYNC entries), per second of the load
            h["applied_per_s"] = (n1 - n0) / r1["seconds"]

        # 2. SIGKILL slot 2; a quorum of 2 commits the rest
        procs[2].send_signal(signal.SIGKILL)
        procs[2].wait(timeout=30)
        r2 = load(urls[0], second, conns, window, load_deadline_s)
        a2 = r2["acked"]
        out["load_one_down"] = _load_row(r2, len(second))
        if not a2:
            raise AssertionError(f"no write acked with slot 2 down; "
                                 f"refusals: {r2['refused']}")

        # 3. restart slot 2 through the stream lane; it catches up
        t0 = time.perf_counter()
        procs[2] = spawn_node(tmp, 2, urls, groups=groups, cap=cap,
                              depth=depth, max_batch_ents=max_batch_ents,
                              backend="tpu", env_extra=env_extra)
        info = wait_ready(procs[2], timeout=300.0)
        out["restart"] = {
            "seconds": info["restart_s"], "lane": info["lane"],
            "raw_crc_launches": info["raw_crc_launches"],
            "raw_crc_largest": info["raw_crc_largest"],
            "ready_s": time.perf_counter() - t0,
            "wal_bytes": sum(
                os.path.getsize(os.path.join(tmp, "d2", "wal", f))
                for f in os.listdir(os.path.join(tmp, "d2", "wal")))}
        target = applied_frontier(urls[0])
        out["restart"]["catch_up_s"] = wait_applied(urls, target,
                                                    settle_s)
        every = a1 + a2 + [warm]
        require_keys(urls, every, groups, "after the restart")
        out["read_back"] = len(every)
        out["restarted_host_stats"] = host_stats(urls[2])
        return out


# -- the role-split topology --------------------------------------------------


def free_port_block(span: int) -> int:
    """A base port ``p`` with ``p..p+span-1`` all bind-free — the
    role topology derives every role's port from its host's base
    (shard s peers on base + m*s, the worker on client + m), so the
    whole block must be clear, not just the base."""
    for _ in range(64):
        socks = []
        try:
            s0 = socket.socket()
            s0.bind(("127.0.0.1", 0))
            base = s0.getsockname()[1]
            if base + span >= 65535:
                continue
            socks.append(s0)
            ok = True
            for off in range(1, span):
                s = socket.socket()
                try:
                    s.bind(("127.0.0.1", base + off))
                    socks.append(s)
                except OSError:
                    ok = False
                    break
            if ok:
                return base
        finally:
            for s in socks:
                s.close()
    raise AssertionError("no free port block of span %d" % span)


def spawn_roles(tmp: str, slot: int, urls: list[str], client_port: int,
                shards: int, *, groups: int, cap: int = 64,
                depth: int = 8, max_batch_ents: int = 32,
                snap_count: int | None = None, bootstrap: bool = False,
                via: str = "dist_node",
                env_extra: dict | None = None) -> subprocess.Popen:
    """One host of the role-split topology: a role supervisor with an
    ingest on ``client_port``, an apply/watch worker on ``client_port
    + m``, ``shards`` serving shards peering on ``peer + m*s`` and its
    merged obs plane on ``client_port + 2m``.  ``via="dist_node"``
    starts it as ``dist_node --roles`` (with ``cap``, ``depth`` and
    ``max_batch_ents``); ``via="cli"`` as ``python -m
    etcd_tpu_torch.cli --dist-slot N --dist-roles S`` (the CLI's role
    mode gives its shards ``cli.ROLE_SHARD_CAP`` log slots and the role
    default batch size, and passes ``depth``).  The supervisor's
    stdout (its children's too: the shards' JSON lines, ``ROLE-READY``
    and ``READY``) goes to ``<tmp>/host<slot>.out``, stderr to
    ``<tmp>/host<slot>.log``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if env_extra:
        env.update(env_extra)
    data = os.path.join(tmp, f"d{slot}")
    if via == "cli":
        cmd = [sys.executable, "-m", "etcd_tpu_torch.cli",
               "--name", "roles", "--data-dir", data,
               "--dist-slot", str(slot), "--dist-peers", ",".join(urls),
               "--dist-roles", str(shards),
               "--cohosted-groups", str(groups),
               "--dist-pipeline-depth", str(depth),
               "--listen-client-urls",
               f"http://127.0.0.1:{client_port}",
               "--advertise-client-urls",
               f"http://127.0.0.1:{client_port}"]
        if snap_count is not None:
            cmd += ["--snapshot-count", str(snap_count)]
        # the CLI bootstraps slot 0 of a fresh cluster itself
    else:
        cmd = [sys.executable, "-m", "etcd_tpu_torch.scripts.dist_node",
               "--data-dir", data,
               "--slot", str(slot), "--peers", ",".join(urls),
               "--groups", str(groups), "--cap", str(cap),
               "--max-batch-ents", str(max_batch_ents),
               "--pipeline-depth", str(depth),
               "--roles", str(shards),
               "--client-port", str(client_port)]
        if snap_count is not None:
            cmd += ["--snap-count", str(snap_count)]
        if bootstrap:
            cmd.append("--bootstrap")
    out = open(os.path.join(tmp, f"host{slot}.out"), "ab")
    err = open(os.path.join(tmp, f"host{slot}.log"), "ab")
    try:
        return subprocess.Popen(cmd, stdout=out, stderr=err, env=env,
                                cwd=REPO)
    finally:
        out.close()
        err.close()


def role_lines(tmp: str, slot: int) -> list[str]:
    """The lines host ``slot``'s role family printed so far."""
    try:
        with open(os.path.join(tmp, f"host{slot}.out")) as f:
            return f.read().splitlines()
    except OSError:
        return []


def shard_infos(tmp: str, slot: int) -> list[dict]:
    """The JSON lines host ``slot``'s shards printed at each (re)start,
    in order."""
    return [json.loads(x) for x in role_lines(tmp, slot)
            if x.startswith("{")]


def wait_roles_ready(tmp: str, procs: list, timeout: float) -> float:
    """Wait until every host's supervisor printed READY; returns the
    seconds waited.  Raises when a supervisor dies or the deadline
    passes, with the tail of its log."""
    t0 = time.perf_counter()
    left = set(range(len(procs)))
    while left:
        for slot in sorted(left):
            if "READY" in (x.strip() for x in role_lines(tmp, slot)):
                left.discard(slot)
            elif procs[slot].poll() is not None:
                raise AssertionError(
                    f"host {slot} exited rc={procs[slot].returncode}: "
                    f"{role_log_tail(tmp, slot)}")
        if left and time.perf_counter() - t0 > timeout:
            raise AssertionError(
                f"hosts {sorted(left)} never printed READY: "
                f"{[role_log_tail(tmp, s) for s in sorted(left)]}")
        if left:
            time.sleep(0.2)
    return time.perf_counter() - t0


def role_log_tail(tmp: str, slot: int, n: int = 2000) -> str:
    try:
        with open(os.path.join(tmp, f"host{slot}.log"), "rb") as f:
            return f.read()[-n:].decode(errors="replace")
    except OSError:
        return ""


def read_roles_file(tmp: str, slot: int) -> dict:
    """Host ``slot``'s ``roles.json``: role -> {pid, port}."""
    with open(os.path.join(tmp, f"d{slot}", "roles.json")) as f:
        return json.load(f)


def role_obs_urls(peer_base: int, client_base: int, m: int,
                  shards: int) -> dict[str, list[str]]:
    """Every role process's obs endpoint, labeled by role name:
    stage tables are per-process registries, so the bench must pull
    each role's own table to attribute CPU per role."""
    out = {}
    out["ingest"] = [f"http://127.0.0.1:{client_base + i}"
                     for i in range(m)]
    out["worker"] = [f"http://127.0.0.1:{client_base + i + m}"
                     for i in range(m)]
    for s in range(shards):
        out[f"shard{s}"] = [
            f"http://127.0.0.1:{peer_base + i + m * s}"
            for i in range(m)]
    return out


class RoleCluster:
    """Three role-split hosts on localhost (:func:`spawn_roles`);
    slot 0 bootstraps every group's leadership on each shard plane."""

    def __init__(self, groups: int, shards: int, *, cap: int = 64,
                 depth: int = 8, max_batch_ents: int = 32,
                 snap_count: int | None = None, via: str = "dist_node",
                 env_extra: dict | None = None, tmp: str | None = None,
                 m: int = 3):
        assert groups % shards == 0, (groups, shards)
        self.m, self.shards, self.groups = m, shards, groups
        self.own_tmp = tmp is None
        self.tmp = tmp or tempfile.mkdtemp(prefix="roles_bench_")
        self.peer_base = free_port_block(m * shards)
        # three disjoint client-side bands: ingest (+0..m), worker
        # (+m..2m), supervisor merged obs (+2m..3m)
        self.client_base = free_port_block(3 * m)
        self.urls = [f"http://127.0.0.1:{self.peer_base + i}"
                     for i in range(m)]
        self.kw = dict(groups=groups, cap=cap, depth=depth,
                       max_batch_ents=max_batch_ents,
                       snap_count=snap_count, via=via,
                       env_extra=env_extra)
        self.procs: list = []

    def ingest(self, slot: int) -> str:
        return f"http://127.0.0.1:{self.client_base + slot}"

    def worker(self, slot: int) -> str:
        return f"http://127.0.0.1:{self.client_base + self.m + slot}"

    def supervisor(self, slot: int) -> str:
        return f"http://127.0.0.1:{self.client_base + 2 * self.m + slot}"

    def shard(self, slot: int, s: int) -> str:
        return f"http://127.0.0.1:{self.peer_base + slot + self.m * s}"

    def start(self, timeout: float = 300.0) -> float:
        """Spawn every host and wait for READY; returns the seconds."""
        self.procs = [spawn_roles(self.tmp, s, self.urls,
                                  self.client_base + s, self.shards,
                                  bootstrap=(s == 0), **self.kw)
                      for s in range(self.m)]
        return wait_roles_ready(self.tmp, self.procs, timeout)

    def stop(self) -> None:
        stop_nodes(self.procs)
        if self.own_tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)

    def __enter__(self) -> "RoleCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def roles_stats(c: RoleCluster) -> dict:
    """The role-split row's server side: the per-role CPU split and
    merged stage table (each role's own registry), the handoff
    stages' CPU share, and the windowed rates and worst-of SLO verdict
    off each host's supervisor-merged ring."""
    by_role = role_obs_urls(c.peer_base, c.client_base, c.m, c.shards)
    per_role_cpu = {}
    merged: dict[str, dict[str, float]] = {}
    for role, rurls in by_role.items():
        st = fetch_stage_stats(rurls)
        per_role_cpu[role] = round(
            sum(r["cpu_s"] for r in st.values()), 3)
        for stage, r in st.items():
            agg = merged.setdefault(
                stage, {"wall_s": 0.0, "cpu_s": 0.0,
                        "device_s": 0.0, "passes": 0})
            for k in ("wall_s", "cpu_s", "device_s", "passes"):
                agg[k] += r[k]
    tot_cpu = sum(r["cpu_s"] for r in merged.values())
    handoff = sum(r["cpu_s"] for s, r in merged.items()
                  if s.startswith("role.handoff_"))
    sup = [c.supervisor(i) for i in range(c.m)]
    return {
        "per_role_cpu_s": per_role_cpu,
        "stage_seconds": {
            s: {k: (round(v, 3) if k != "passes" else int(v))
                for k, v in r.items()}
            for s, r in sorted(merged.items(),
                               key=lambda kv: -kv[1]["cpu_s"])},
        "handoff_cpu_s": round(handoff, 3),
        "handoff_cpu_share": (round(handoff / tot_cpu, 4)
                              if tot_cpu else 0.0),
        "windowed": fetch_windowed(sup),
        "slo": fetch_slo(sup),
    }


def run_roles_once(total: int, conns: int, window: int, shards: int, *,
                   groups: int = 64, cap: int = 1024, depth: int = 8,
                   max_batch_ents: int = 128,
                   load_deadline_s: float = 180.0,
                   env_extra: dict | None = None) -> dict:
    """One write-bench run over the role-split topology: 3 hosts, each
    a supervised family of (ingest + worker + ``shards`` serving
    shards); ``total`` proposals from ``conns`` connections in windows
    of ``window`` go to host 0's INGEST port, which coalesces them into
    packed DRH1 handoff frames to its local shard leaders.  The row
    carries the client's acked writes/s and ack p50/p99, the merged
    stage table and the per-role CPU split.  (The reference's client
    asks for the DCB1 reply; this one reads the JSON reply.)"""
    ns = 8 * groups
    keys = [f"/b{i % ns}/k{i}" for i in range(total)]
    with RoleCluster(groups, shards, cap=cap, depth=depth,
                     max_batch_ents=max_batch_ents,
                     env_extra=env_extra) as c:
        start_s = c.start()
        warm_up(c.ingest(0), "/warm/k")
        r = load(c.ingest(0), keys, conns, window, load_deadline_s)
        return {
            "hosts": c.m, "groups": groups, "cap": cap,
            "conns": conns, "window": window,
            "serving_shards": shards, "pipeline_depth": depth,
            "host_cores": os.cpu_count(), "namespaces": ns,
            "backend": f"3 supervised role families x "
                       f"(ingest + worker + {shards} shards)",
            "start_s": start_s, **_load_row(r, total),
            **roles_stats(c)}


def run_profile_overhead(total: int, conns: int, window: int, *,
                         groups: int, cap: int, depth: int,
                         max_batch_ents: int) -> dict:
    """The sampling profiler's overhead: the SAME workload with the
    always-on profiler at its default rate and fully off
    (``ETCD_PROFILE_HZ=0``), acked writes/s compared.  Each arm runs
    twice, interleaved, and the arm's figure is its best run; while the
    overhead reads above 2%, up to four more interleaved pairs run (the
    reference's estimator: run-to-run jitter of fresh 3-process
    clusters exceeds the effect being measured)."""
    on_rows, off_rows = [], []

    def one(hz):
        return run_load_once(groups=groups, cap=cap, total=total,
                             conns=conns, window=window, depth=depth,
                             max_batch_ents=max_batch_ents,
                             env_extra=(None if hz is None
                                        else {"ETCD_PROFILE_HZ": hz}))

    def best_overhead():
        on = max(r["acked_writes_per_s"] for r in on_rows)
        off = max(r["acked_writes_per_s"] for r in off_rows) or 1.0
        return on, off, max(0.0, 100.0 * (off - on) / off)

    for _ in range(2):
        on_rows.append(one(None))
        off_rows.append(one("0"))
    on_pps, off_pps, overhead = best_overhead()
    while overhead > 2.0 and len(on_rows) < 6:
        on_rows.append(one(None))
        off_rows.append(one("0"))
        on_pps, off_pps, overhead = best_overhead()
    return {
        "bench": "dist_profile_overhead", "groups": groups,
        "proposals": total, "conns": conns, "window": window,
        "pipeline_depth": depth,
        "runs_per_arm": len(on_rows), "estimator": "best-of-arm",
        "profiled_pps": on_pps, "unprofiled_pps": off_pps,
        "profiled_runs": [r["acked_writes_per_s"] for r in on_rows],
        "unprofiled_runs": [r["acked_writes_per_s"] for r in off_rows],
        "profile_overhead_pct": round(overhead, 2),
    }


def run_load_once(groups: int, cap: int, total: int, conns: int,
                  window: int, depth: int, max_batch_ents: int,
                  env_extra: dict | None = None,
                  load_deadline_s: float = 180.0) -> dict:
    """:func:`node_cluster`, the warm-up write, ``total`` proposals to
    host 0 and the load's row (no kill, no restart)."""
    ns = 8 * groups
    keys = [f"/b{i % ns}/k{i}" for i in range(total)]
    with node_cluster(groups, cap, depth, max_batch_ents,
                      env_extra) as (_, urls, _, _):
        warm_up(urls[0], "/warm/k")
        return _load_row(load(urls[0], keys, conns, window,
                              load_deadline_s), total)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, default=10_000)
    ap.add_argument("--cap", type=int, default=1024)
    ap.add_argument("--total", type=int, default=16_000)
    ap.add_argument("--extra", type=int, default=2_000)
    ap.add_argument("--conns", type=int, default=8)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--max-batch-ents", type=int, default=128)
    ap.add_argument("--roles", type=int, default=0, metavar="S",
                    help="run the load against the role-split topology "
                         "(3 hosts x ingest + worker + S shards) "
                         "instead")
    ap.add_argument("--profile-overhead", action="store_true",
                    help="the load with the sampling profiler on and "
                         "off (ETCD_PROFILE_HZ=0), acked writes/s of "
                         "both arms")
    a = ap.parse_args(argv)
    if a.roles:
        row = run_roles_once(a.total, a.conns, a.window, a.roles,
                             groups=a.groups, cap=a.cap, depth=a.depth,
                             max_batch_ents=a.max_batch_ents)
    elif a.profile_overhead:
        row = run_profile_overhead(a.total, a.conns, a.window,
                                   groups=a.groups, cap=a.cap,
                                   depth=a.depth,
                                   max_batch_ents=a.max_batch_ents)
    else:
        row = run(groups=a.groups, cap=a.cap, total=a.total,
                  conns=a.conns, window=a.window, extra=a.extra,
                  depth=a.depth, max_batch_ents=a.max_batch_ents)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
