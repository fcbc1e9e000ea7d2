"""The role-split topology on the port, driven end to end: the role
phase of ``chip_smoke.py``.

Three hosts on localhost, each a role supervisor (``server/roles.py``)
started through the user's entry point, ``python -m etcd_tpu_torch.cli
--dist-slot i --dist-roles S``: an ingest, an apply/watch worker and S
serving shards, each shard a ``DistServer`` over ``groups / S`` groups
of ``cli.ROLE_SHARD_CAP`` log slots on its own device context.  The
supervisors run with ``ETCD_REPLAY_BACKEND=stream``, which their
children inherit, so a restarted shard replays its WAL on the stream
lane.  Every write of every step below must be acked: a refusal fails
the run.  Then:

1. ``total`` proposals from ``conns`` connections in windows of
   ``window`` go to host 0's ingest (:func:`dist_bench.load`); every
   host's shards apply up to their plane leader's frontier;
2. shard S-1 of host 2 is SIGKILLed and ``extra`` more proposals
   commit on the remaining quorum; the supervisor respawns the shard,
   whose restart (seconds, lane, raw-CRC launches) is read off the JSON
   line it prints, and it must catch up with its plane's frontier (the
   highest index any host of the plane applied: after an election a
   group's leader may sit on any host);
3. host 0's worker is SIGKILLed once its mirror holds the writes so
   far; ``watch_keys`` keys (in one directory a plane, so each
   directory's keys share one group) are written while it is down and
   as many after its replacement answers; watch streams on the
   replacement (``waitIndex=1``: the mirror's history and then live
   events) must show every one, none more often than watches on host
   1's worker, which was never killed, show it (once, unless the log
   holds the write twice), and no event twice: the new worker resumed
   at the ring's tail, with no record replayed and none lost;
4. the supervisors' merged ``/mraft/obs/timeseries`` and
   ``/mraft/obs/slo`` and an ingest's ``/v2/stats/slo`` answer 200, the
   merged rings show a non-zero acked rate, ``etcd_role_up`` is 1 for
   every role of every host, and a shard's
   ``etcd_profile_samples_total`` holds samples of an ownership domain;
5. once every host's shards have applied their plane's frontier,
   every acked key reads back, value = key, through every host's ingest
   (``/mraft/get_many``, linearizable, one connection a plane; a read
   refused for a transient cause, such as a leadership change, is sent
   again, up to ``READ_RETRIES`` times);
6. with ``gpu_check=True``, CUDA contexts in the shard processes only:
   ``nvidia-smi --query-compute-apps`` counts one more context a shard
   than before the cluster started (inside a container's PID namespace
   nvidia-smi may report every process as PID 1, so the count, not the
   PIDs, is compared), and
   every shard PID, and no ingest, worker or supervisor PID, maps the
   card's device files (``/proc/<pid>/maps``).

:func:`run` returns the numbers as a dict; it raises on any failed
check.

    python -m etcd_tpu_torch.scripts.roles_bench [--groups G] ...

prints that dict as one JSON line; the shards run on CUDA unless
``ETCD_TORCH_DEVICE`` names another device.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..cli import ROLE_SHARD_CAP
from ..server.distserver import pack_requests
from ..server.multigroup import group_of
from ..server.server import gen_id
from ..utils.diskstat import wal_snap_usage
from ..utils.errors import ECODE_KEY_NOT_FOUND
from ..wire.requests import Request
from .dist_bench import (
    RoleCluster,
    _load_row,
    applied_frontier,
    load,
    read_roles_file,
    roles_stats,
    shard_infos,
    wait_applied,
    warm_up,
)

#: times a read refused for a transient cause is sent again
READ_RETRIES = 5


def _get(url: str, timeout: float = 10.0) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_for(what: str, fn, timeout: float, every: float = 0.2):
    """Poll ``fn`` until it returns a truthy value (returned) or the
    deadline passes (raises naming ``what``)."""
    deadline = time.perf_counter() + timeout
    while True:
        try:
            got = fn()
        except (OSError, ValueError, KeyError, http.client.HTTPException):
            got = None
        if got:
            return got
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what} after {timeout} s")
        time.sleep(every)


def all_acked(what: str, r: dict, n: int) -> list[str]:
    """The keys a :func:`dist_bench.load` of ``n`` proposals acked;
    raises unless it acked every one."""
    if len(r["acked"]) != n:
        raise AssertionError(f"{what}: {len(r['acked'])} of {n} writes "
                             f"acked, refused {r['refused']}")
    return r["acked"]


def plane_frontier(c: RoleCluster, s: int, hosts) -> np.ndarray:
    """[G/S] highest applied index any of ``hosts`` reports on plane
    ``s``: a group's leader may sit on any host after an election."""
    return np.maximum.reduce([applied_frontier(c.shard(h, s))
                              for h in hosts])


def planes_caught_up(c: RoleCluster, timeout: float) -> float:
    """Wait until every host's shard s has applied the highest frontier
    of its plane; returns the seconds waited."""
    t0 = time.perf_counter()
    for s in range(c.shards):
        wait_applied([c.shard(h, s) for h in range(c.m)],
                     plane_frontier(c, s, range(c.m)),
                     max(1.0, timeout - (time.perf_counter() - t0)))
    return time.perf_counter() - t0


def where(c: RoleCluster, key: str) -> dict:
    """Where ``key`` lives: its plane, its group there, and per host
    that group's applied index and whether the host leads it."""
    s = group_of(key, c.shards)
    g = group_of(key, c.groups // c.shards)
    hosts = {}
    for h in range(c.m):
        lead = json.loads(_get(c.shard(h, s) + "/mraft/leaders")[1])
        hosts[h] = (int(applied_frontier(c.shard(h, s))[g]),
                    bool(lead["lead"][g]))
    return {"key": key, "plane": s, "group": g,
            "applied_and_lead_by_host": hosts}


def get_many(url: str, keys: list[str], shards: int, batch: int = 512
             ) -> tuple[dict, dict]:
    """Values of ``keys`` through one ingest's ``/mraft/get_many``:
    linearizable reads (the ingest re-marshals the batch's requests, and
    the request marshal carries no serializable flag).  Returns the
    values and the error of each read that failed, by key.  One
    connection a plane, each sending only its plane's keys, so each
    shard serves one batch at a time: more at once starve the shards'
    round loops (they share each shard's interpreter lock) into
    elections."""
    host, port = url.split("//")[1].split(":")

    def one(part: list[str]) -> tuple[dict, dict]:
        c = http.client.HTTPConnection(host, int(port), timeout=120)
        vals, errs = {}, {}
        try:
            for lo in range(0, len(part), batch):
                chunk = part[lo:lo + batch]
                body = pack_requests([Request(method="GET", path=k,
                                              id=gen_id())
                                      for k in chunk])
                c.request("POST", "/mraft/get_many", body=body,
                          headers={"Content-Type":
                                   "application/octet-stream"})
                r = c.getresponse()
                doc = json.loads(r.read())
                if r.status != 200:
                    raise AssertionError(f"get_many on {url}: "
                                         f"{r.status} {doc}")
                vals.update(zip(chunk, doc["vals"]))
                for i, e in doc["errs"].items():
                    errs[chunk[int(i)]] = (e["errorCode"], e["message"])
        finally:
            c.close()
        return vals, errs

    planes = [[k for k in keys if group_of(k, shards) == s]
              for s in range(shards)]
    vals, errs = {}, {}
    with ThreadPoolExecutor(shards) as ex:
        for v, e in ex.map(one, planes):
            vals.update(v)
            errs.update(e)
    return vals, errs


class WatchStream:
    """A recursive streaming watch (``wait=true&stream=true``) of the
    directory ``d`` on one front door, read on a thread: the (key,
    modifiedIndex) of its events, in arrival order.  ``wait_index=None``
    watches from now on.  A front door evicts a watch that falls more
    than its queue behind, so a watch covers one directory, not the
    whole keyspace."""

    def __init__(self, url: str, d: str, wait_index: int | None):
        host, port = url.split("//")[1].split(":")
        self.events: list[tuple[str, int]] = []
        self.conn = http.client.HTTPConnection(host, int(port),
                                               timeout=120)
        since = "" if wait_index is None else f"&waitIndex={wait_index}"
        self.conn.request(
            "GET", f"/v2/keys{d}?wait=true&recursive=true&stream=true"
                   f"{since}")
        self.resp = self.conn.getresponse()
        if self.resp.status != 200:
            raise AssertionError(f"watch on {url}: {self.resp.status} "
                                 f"{self.resp.read()[:300]}")
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        try:
            self._lines()
            self.error = EOFError("the watch stream ended")
        except (OSError, ValueError, AttributeError,
                http.client.HTTPException) as e:
            # a close() under the reader ends it the same way
            self.error = e

    def _lines(self) -> None:
        for line in self.resp:
            line = line.strip()
            if not line:
                continue  # keepalive
            node = json.loads(line)["node"]
            self.events.append((node["key"], node["modifiedIndex"]))

    def keys(self) -> set[str]:
        return {k for k, _ in self.events}

    def close(self) -> None:
        # shut the socket first: the reader thread holds the response
        # in a blocking read that close() alone would wait out
        if self.conn.sock is not None:
            self.conn.sock.shutdown(socket.SHUT_RDWR)
        self.thread.join(10)
        self.conn.close()


def cuda_contexts() -> list[str]:
    """One line a CUDA context on the machine, per nvidia-smi (PID and
    device memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout
    return [x.strip() for x in out.splitlines() if x.strip()]


def maps_card(pid: int) -> bool:
    """Whether process ``pid`` maps the card's device files (a CUDA
    context does; importing torch does not)."""
    with open(f"/proc/{pid}/maps") as f:
        return any("/dev/nvidia" in line for line in f)


def role_up(c: RoleCluster) -> dict:
    """Per host, ``etcd_role_up`` of every role in the merged view."""
    out = {}
    for h in range(c.m):
        _, body = _get(c.supervisor(h) + "/mraft/obs")
        fam = json.loads(body)["families"]["etcd_role_up"]["samples"]
        out[h] = {s["labels"]["role"]: s["value"] for s in fam}
    return out


def run(groups: int = 10_000, shards: int = 2, total: int = 16_000,
        extra: int = 2_000, conns: int = 8, window: int = 512,
        snap_count: int = 2_000, watch_keys: int = 200,
        gpu_check: bool = False, load_deadline_s: float = 180.0,
        settle_s: float = 240.0, env_extra: dict | None = None,
        tmp: str | None = None) -> dict:
    """The run described in the module docstring."""
    env = {"ETCD_REPLAY_BACKEND": "stream", **(env_extra or {})}
    ns = 8 * groups
    names = [f"/b{i % ns}/k{i}" for i in range(total + extra + 1)]
    warm, first, second = names[0], names[1:total + 1], names[total + 1:]
    c = RoleCluster(groups, shards, snap_count=snap_count, via="cli",
                    env_extra=env, tmp=tmp)
    out: dict = {"hosts": c.m, "groups": groups, "shards": shards,
                 "groups_per_shard": groups // shards,
                 "cap": ROLE_SHARD_CAP, "snap_count": snap_count,
                 "conns": conns, "window": window, "namespaces": ns}
    steps: dict[str, float] = {}
    out["steps_s"] = steps
    ctx0 = cuda_contexts() if gpu_check else []
    t_step = time.perf_counter()

    def step(name: str) -> None:
        nonlocal t_step
        now = time.perf_counter()
        steps[name] = now - t_step
        t_step = now

    try:
        out["start_s"] = c.start()
        out["device"] = shard_infos(c.tmp, 0)[0]["device"]
        warm_up(c.ingest(0), warm)
        step("start")

        # 1. the load through host 0's ingest
        r1 = load(c.ingest(0), first, conns, window, load_deadline_s)
        out["load"] = _load_row(r1, len(first))
        a1 = all_acked("the load", r1, len(first))
        out["settle_s"] = planes_caught_up(c, settle_s)
        out.update(roles_stats(c))
        out["snapshots"] = {
            f"{h}/shard{s}": wal_snap_usage(
                os.path.join(c.tmp, f"d{h}", f"shard{s}"))["snap_files"]
            for h in range(c.m) for s in range(shards)}

        step("load")

        # 2. SIGKILL shard S-1 of host 2; the rest commit without it
        victim = f"shard{shards - 1}"
        old = read_roles_file(c.tmp, 2)[victim]["pid"]
        os.kill(old, signal.SIGKILL)
        t_kill = time.perf_counter()
        r2 = load(c.ingest(0), second, conns, window, load_deadline_s)
        out["load_one_down"] = _load_row(r2, len(second))
        a2 = all_acked(f"{victim} of host 2 down", r2, len(second))
        info = wait_for(
            f"{victim} of host 2 never restarted",
            lambda: [x for x in shard_infos(c.tmp, 2)
                     if x["role"] == victim and x["pid"] != old],
            settle_s)[-1]
        wait_for(f"{victim} of host 2 never answered",
                 lambda: _get(c.shard(2, shards - 1) + "/mraft/leaders")[0]
                 == 200, settle_s)
        target = plane_frontier(c, shards - 1, range(c.m - 1))
        catch_up = wait_applied([c.shard(2, shards - 1)], target,
                                settle_s)
        out["shard_restart"] = {
            "role": victim, "host": 2, "pid": info["pid"],
            "seconds": info["restart_s"], "lane": info["lane"],
            "raw_crc_launches": info["raw_crc_launches"],
            "raw_crc_largest": info["raw_crc_largest"],
            "up_after_kill_s": time.perf_counter() - t_kill - catch_up,
            "catch_up_s": catch_up}
        # on the CPU the stream lane runs the plain CRC: no launch
        if info["lane"] != "stream" or (info["device"] == "cuda"
                                        and info["raw_crc_launches"] <= 0):
            raise AssertionError(f"the respawned shard's restart: "
                                 f"{out['shard_restart']}")

        step("shard_respawn")

        # 3. SIGKILL host 0's worker once its mirror holds the writes so
        # far; the writes made while it is down and after it is back
        # show on a watch of its replacement, none more often than on a
        # watch of host 1's worker, which was never killed and mirrors
        # the same logs (a write the log holds twice shows twice on both)
        last = a2[-1]
        wait_for("host 0's worker never mirrored the load",
                 lambda: _get(c.worker(0) + "/v2/keys" + last)[0] == 200,
                 settle_s)
        # one directory a plane, each watched on its own
        dirs = [next(d for d in (f"/wk{n}" for n in range(1000))
                     if group_of(d, shards) == s) for s in range(shards)]
        refs = [WatchStream(c.worker(1), d, None) for d in dirs]
        wss: list = []
        try:
            old_w = read_roles_file(c.tmp, 0)["worker"]["pid"]
            os.kill(old_w, signal.SIGKILL)
            wk = [f"{dirs[j % shards]}/k{j}" for j in range(2 * watch_keys)]
            r_down = load(c.ingest(0), wk[:watch_keys], conns, window,
                          load_deadline_s)
            wait_for("host 0's worker never respawned",
                     lambda: read_roles_file(c.tmp, 0)["worker"]["pid"]
                     != old_w, settle_s)
            wait_for("host 0's new worker never answered",
                     lambda: _get(c.worker(0) + "/v2/machines")[0]
                     == 200, settle_s)
            wss = [WatchStream(c.worker(0), d, 1) for d in dirs]
            r_up = load(c.ingest(0), wk[watch_keys:], conns, window,
                        load_deadline_s)
            out["worker_window"] = {"down": _load_row(r_down, watch_keys),
                                    "up": _load_row(r_up, watch_keys)}
            down = all_acked("host 0's worker down", r_down, watch_keys)
            up = all_acked("host 0's worker back", r_up, watch_keys)
            want = set(down + up)

            def keys(streams) -> set[str]:
                return set().union(*(w.keys() for w in streams))

            def errors() -> list:
                return [w.error for w in wss + refs if w.error]

            try:
                wait_for("the new worker's watches missed events",
                         lambda: want <= keys(wss) or errors(), settle_s)
            except AssertionError as e:
                raise AssertionError(
                    f"{e}: {len(want - keys(wss))} of {len(want)} keys "
                    f"missing") from None

            def extra() -> Counter:
                # a key shown more often than on host 1's worker (one
                # show always allowed: a follower that installed a
                # snapshot mirrors its keys without their events)
                log = Counter(k for w in refs for k, _ in w.events)
                return Counter({k: n - max(1, log[k]) for k, n in Counter(
                    k for w in wss for k, _ in w.events).items()
                    if n > max(1, log[k])})

            time.sleep(1.0)  # a duplicate would arrive by now
            # host 1's worker may still be behind: let it catch up
            t_end = time.monotonic() + 10.0
            while extra() and time.monotonic() < t_end:
                time.sleep(0.2)
            seen = [e for w in wss for e in w.events]
            logged = [e for w in refs for e in w.events]
            dup = extra()
            errs = errors()
        finally:
            for w in refs + wss:
                w.close()
        per_key_log = Counter(k for k, _ in logged)
        lost = want - {k for k, _ in seen}
        out["worker_respawn"] = {
            "written_down": len(down), "written_up": len(up),
            "events": len(seen), "events_host1": len(logged),
            "committed_twice": sum(n - 1 for n in per_key_log.values()),
            "duplicates": sum(dup.values()), "missing": len(lost),
            "repeated_events": len(seen) - len(set(seen))}
        if dup or lost or len(seen) != len(set(seen)):
            raise AssertionError(
                f"watch after the worker's respawn: "
                f"{out['worker_respawn']}; extra {dict(dup)}, missing "
                f"{sorted(lost)[:5]}; stream errors {errs!r}; the keys' "
                f"events on the new worker "
                f"{[e for e in seen if e[0] in dup][:6]} and on host "
                f"1's {[e for e in logged if e[0] in dup][:6]}")

        step("worker_respawn")

        # 4. the merged observability plane (before the read-back,
        # which takes longer than the rings' short windows)
        from ..obs import timeseries

        snaps = []
        for h in range(c.m):
            for path in ("/mraft/obs/timeseries", "/mraft/obs/slo"):
                st, body = _get(c.supervisor(h) + path)
                if st != 200:
                    raise AssertionError(f"host {h} {path}: {st}")
                if path.endswith("timeseries"):
                    snaps.append(json.loads(body))
        st, body = _get(c.ingest(0) + "/v2/stats/slo")
        if st != 200:
            raise AssertionError(f"ingest /v2/stats/slo: {st}")
        out["ingest_slo"] = json.loads(body)["verdict"]
        out["merged_acked_per_s_120s"] = timeseries.snap_rate(
            snaps, "etcd_ack_rtt_seconds", 120.0)
        if not out["merged_acked_per_s_120s"] > 0:
            raise AssertionError("the merged rings show no acked write")
        out["merged_windowed"] = timeseries.windowed_summary(snaps)
        ups = wait_for(
            "etcd_role_up is not 1 for every role after the respawns",
            lambda: (lambda u: u if all(
                v == 1.0 for h in u.values() for v in h.values())
                and all(len(h) == 2 + shards + 1 for h in u.values())
                else None)(role_up(c)), 30.0, every=0.5)
        out["role_up"] = ups
        _, body = _get(c.shard(0, 0) + "/mraft/obs")
        prof = json.loads(body)["etcd_profile_samples_total"]["samples"]
        out["profile_domains"] = sorted(
            {s["labels"]["domain"] for s in prof if s["value"] > 0})
        if not [d for d in out["profile_domains"] if d != "-"]:
            raise AssertionError(f"no profile sample of an ownership "
                                 f"domain: {out['profile_domains']}")

        step("obs")

        # 5. every acked key reads back through every host's ingest
        every = a1 + a2 + down + up + [warm]
        out["groups_led"] = {
            f"{h}/shard{s}": int(sum(json.loads(_get(
                c.shard(h, s) + "/mraft/leaders")[1])["lead"]))
            for h in range(c.m) for s in range(shards)}
        out["catch_up_all_s"] = planes_caught_up(c, settle_s)
        lost, failed, retried = {}, {}, {}
        for h in range(c.m):
            vals, errs = get_many(c.ingest(h), every, shards)
            failed[h] = Counter(m for _, m in errs.values())
            retried[h] = 0
            for _ in range(READ_RETRIES):
                # a read refused for a transient cause (a leadership
                # change, a timeout) is sent again, as a client would;
                # a key not found is an answer
                again = [k for k, (code, _m) in errs.items()
                         if code != ECODE_KEY_NOT_FOUND]
                if not again:
                    break
                retried[h] += len(again)
                time.sleep(1.0)
                v2, e2 = get_many(c.ingest(h), again, shards)
                vals.update(v2)
                for k in again:
                    errs.pop(k)
                errs.update(e2)
            lost[h] = [k for k in every if vals.get(k) != k]
        out["read_errors"] = {h: dict(v) for h, v in failed.items()}
        out["read_retried"] = retried
        if any(lost.values()):
            raise AssertionError(
                "acked keys not read back, by host: "
                f"{ {h: (len(v), v[:3]) for h, v in lost.items()} }; "
                f"the first reads' errors by host {failed}, reads sent "
                f"again {retried}; "
                f"{[where(c, k) for v in lost.values() for k in v[:2]]}")
        out["read_back"] = len(every)

        step("read_back")

        # 6. CUDA contexts only in the shard processes
        pids = {h: read_roles_file(c.tmp, h) for h in range(c.m)}
        shard_pids = {v["pid"] for p in pids.values()
                      for r, v in p.items() if r.startswith("shard")}
        other_pids = {v["pid"] for p in pids.values()
                      for r, v in p.items() if not r.startswith("shard")}
        out["shard_pids"] = sorted(shard_pids)
        out["other_pids"] = sorted(other_pids)
        if gpu_check:
            ctx1 = cuda_contexts()
            mapped = sorted(p for p in shard_pids | other_pids
                            if maps_card(p))
            out["cuda_contexts"] = {"before": ctx0, "during": ctx1,
                                    "pids_mapping_the_card": mapped}
            if (len(ctx1) - len(ctx0) != len(shard_pids)
                    or mapped != sorted(shard_pids)):
                raise AssertionError(
                    f"CUDA contexts {ctx0} before the cluster, {ctx1} "
                    f"during it; PIDs mapping the card {mapped}; shard "
                    f"PIDs {sorted(shard_pids)}, others "
                    f"{sorted(other_pids)}")
        step("gpu_check")
        return out
    finally:
        c.stop()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, default=10_000)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--total", type=int, default=16_000)
    ap.add_argument("--extra", type=int, default=2_000)
    ap.add_argument("--conns", type=int, default=8)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--snap-count", type=int, default=2_000)
    a = ap.parse_args(argv)
    print(json.dumps(run(groups=a.groups, shards=a.shards, total=a.total,
                         extra=a.extra, conns=a.conns, window=a.window,
                         snap_count=a.snap_count)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
