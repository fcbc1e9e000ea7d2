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

    python -m etcd_tpu_torch.scripts.dist_bench [--groups G] [--total N]

runs it and prints the result as one JSON line; the nodes run on CUDA
unless ``ETCD_TORCH_DEVICE`` names another device.
"""

from __future__ import annotations

import argparse
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


def run(groups: int = 10_000, cap: int = 1024, total: int = 16_000,
        conns: int = 8, window: int = 512, extra: int = 2_000,
        depth: int = 8, max_batch_ents: int = 128,
        load_deadline_s: float = 180.0, settle_s: float = 240.0,
        env_extra: dict | None = None, tmp: str | None = None) -> dict:
    """The 3-process run described in the module docstring."""
    own_tmp = tmp is None
    tmp = tmp or tempfile.mkdtemp(prefix="dist_bench_")
    ports = free_ports(3)
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    ns = 8 * groups
    names = [f"/b{i % ns}/k{i}" for i in range(total + extra + 1)]
    warm, first, second = names[0], names[1:total + 1], names[total + 1:]
    procs: list = [None, None, None]
    out: dict = {"groups": groups, "cap": cap, "hosts": 3,
                 "conns": conns, "window": window,
                 "pipeline_depth": depth, "max_batch_ents": max_batch_ents,
                 "namespaces": ns,
                 "state_bytes_per_host": groups * cap * 4
                 + groups * (10 * 4 + 3 * (4 + 4 + 1))}
    try:
        t0 = time.perf_counter()
        procs = [spawn_node(tmp, s, urls, groups=groups, cap=cap,
                            depth=depth, max_batch_ents=max_batch_ents,
                            bootstrap=(s == 0), env_extra=env_extra)
                 for s in range(3)]
        # followers first: slot 0's READY waits on its bootstrap
        infos = [wait_ready(procs[s], timeout=300.0) for s in (1, 2, 0)]
        out["start_s"] = time.perf_counter() - t0
        out["device"] = infos[0].get("device")
        # the warm-up write, re-sent (new id) until a leader acks it,
        # as a client would
        c = http.client.HTTPConnection("127.0.0.1", ports[0], timeout=180)
        for attempt in range(60):
            ok, msgs = propose_many(c, [Request(
                method="PUT", id=(1 << 50) + attempt, path=warm,
                val=warm)])
            if ok[0]:
                break
            time.sleep(0.5)
        c.close()
        if not ok[0]:
            raise AssertionError(f"the warm-up write was refused: {msgs}")

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
    finally:
        stop_nodes(procs)
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)


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
    a = ap.parse_args(argv)
    print(json.dumps(run(groups=a.groups, cap=a.cap, total=a.total,
                         conns=a.conns, window=a.window, extra=a.extra,
                         depth=a.depth, max_batch_ents=a.max_batch_ents)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
