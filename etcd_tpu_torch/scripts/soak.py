"""Long-running co-hosted-server soak: continuous mixed load, RSS,
DISK and throughput sampled on a cadence — the stability/leak
evidence a point-in-time suite cannot give.  The port of
``scripts/soak.py``: the port's ``MultiGroupServer``, on CUDA unless
``--device`` names another device.

    python -m etcd_tpu_torch.scripts.soak [MINUTES] [GROUPS] [SNAP_COUNT]
        [--device cpu] [--warmup-s 120] [--report-s 30]
        (default 30, 256, 2000)

Load mix per iteration: PUTs across G namespaces (round-robin), a
GET, a periodic DELETE, a TTL key, and a watch register+fire+drain.
Prints one status line per ``--report-s`` seconds (elapsed, ops, RSS,
WAL/snap dir bytes + file counts) and a final JSON summary; nonzero
exit on any op error, an RSS that doubles the post-warmup baseline
(taken at the first report after ``--warmup-s`` seconds), or the
bounded-disk gate: WAL segment / snapshot file counts exceeding their
fixed bounds once snapshotting has begun (segment GC keeps at most the
covering + current segments; retention keeps the newest K snapshots).
The defaults of ``--warmup-s`` and ``--report-s`` are the reference's;
a run shorter than the warmup has no RSS gate, so a short run passes
smaller values.
"""

from __future__ import annotations

import argparse
import json
import resource
import shutil
import sys
import tempfile
import time

from ..utils.diskstat import wal_snap_usage as disk_sample


def rss_mb() -> float:
    """CURRENT resident set from /proc/self/status VmRSS — the
    sampled series and the leak gate need a value that can go DOWN;
    ru_maxrss is the monotone peak (an early warm-up spike would
    inflate the post-warmup baseline and mask a real leak)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    # non-procfs platform: fall back to the peak (still monotone,
    # but better than nothing)
    return peak_rss_mb()


def peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("minutes", type=float, nargs="?", default=30.0)
    ap.add_argument("groups", type=int, nargs="?", default=256)
    # snapshot cadence: small enough that a saturation soak crosses
    # it many times, so the bounded-disk gate actually bites
    ap.add_argument("snap_count", type=int, nargs="?", default=2000)
    ap.add_argument("--device", default=None,
                    help="torch device of the server (default: CUDA)")
    ap.add_argument("--warmup-s", type=float, default=120.0)
    ap.add_argument("--report-s", type=float, default=30.0)
    a = ap.parse_args(argv)
    minutes, g, snap_count = a.minutes, a.groups, a.snap_count

    from ..server.multigroup import MultiGroupServer
    from ..wire.requests import Request

    d = tempfile.mkdtemp(prefix="soak")
    srv = MultiGroupServer(d, g=g, m=3, cap=64,
                           snap_count=snap_count, device=a.device)
    srv.start()
    rid = [0]

    def req(**kw):
        rid[0] += 1
        return Request(id=rid[0], **kw)

    t0 = time.time()
    deadline = t0 + minutes * 60
    next_report = t0 + a.report_s
    ops = errors = 0
    watch_fired = 0
    baseline_rss = None
    samples = []
    i = 0
    try:
        while time.time() < deadline:
            ns = f"/ns{i % g}"
            try:
                srv.do(req(method="PUT", path=f"{ns}/k{i % 17}",
                           val=f"v{i}"), timeout=30)
                ops += 1
                if i % 7 == 0:
                    srv.do(req(method="GET", path=f"{ns}/k{i % 17}"))
                    ops += 1
                if i % 31 == 0:
                    srv.do(req(method="DELETE",
                               path=f"{ns}/k{i % 17}"), timeout=30)
                    ops += 1
                if i % 13 == 0:
                    srv.do(req(method="PUT", path=f"{ns}/ttl",
                               val="x",
                               expiration=int(
                                   (time.time() + 2) * 1e9)),
                           timeout=30)
                    ops += 1
                if i % 11 == 0:
                    w = srv.store.watch(f"{ns}/w", False, False, 0)
                    srv.do(req(method="PUT", path=f"{ns}/w",
                               val=f"w{i}"), timeout=30)
                    ops += 1
                    if w.next_event(timeout=10) is not None:
                        watch_fired += 1
                    w.remove()
            except Exception as e:  # any op failure fails the soak
                errors += 1
                print(f"op error at i={i}: {e!r}", flush=True)
                if errors > 5:
                    break
            i += 1
            now = time.time()
            if now >= next_report:
                cur = rss_mb()
                if baseline_rss is None and now - t0 > a.warmup_s:
                    baseline_rss = cur  # post-warmup baseline
                samples.append({"t_s": round(now - t0, 1),
                                "ops": ops, "rss_mb": round(cur, 1),
                                **disk_sample(d)})
                print(json.dumps(samples[-1]), flush=True)
                next_report = now + a.report_s
    finally:
        try:
            srv.stop()
        except Exception:
            pass
        final_disk = disk_sample(d)
        snapshots_taken = srv._snapi > 0
        shutil.rmtree(d, ignore_errors=True)

    final = rss_mb()
    leak = (baseline_rss is not None and final > 2 * baseline_rss)
    # bounded-disk gate: once snapshotting has run, segment GC and
    # snapshot retention must hold the counts at their fixed bounds —
    # unbounded growth under sustained traffic is the failure this
    # subsystem exists to prevent
    disk_bounded = True
    # WAL bound: GC keeps segments back to the OLDEST retained
    # snapshot (the corrupt-newest fallback needs that coverage), so
    # the steady state is ~one segment per retained snapshot plus
    # the live one (+1 mid-snapshot margin)
    seg_bound = srv.ss.keep + 2
    if snapshots_taken:
        disk_bounded = (
            final_disk["wal_segments"] <= seg_bound
            and final_disk["snap_files"] <= srv.ss.keep)
        if not disk_bounded:
            print(f"DISK BOUND VIOLATED: {final_disk} "
                  f"(bounds: wal_segments<={seg_bound}, "
                  f"snap_files<={srv.ss.keep})", flush=True)
    # the full obs ledger — span histograms, wal fsync latency, apply
    # batches, elections, devledger transfer counters — rides the
    # soak artifact, so a long run carries its own observability
    # record
    from ..obs.metrics import registry as obs_registry

    summary = {
        "minutes": round((time.time() - t0) / 60, 1), "groups": g,
        "device": str(srv.device),
        "ops": ops, "errors": errors, "watch_fired": watch_fired,
        "ops_per_sec": round(ops / max(1e-9, time.time() - t0), 1),
        "rss_baseline_mb": round(baseline_rss or 0, 1),
        "rss_final_mb": round(final, 1),
        "rss_peak_mb": round(peak_rss_mb(), 1), "rss_doubled": leak,
        "rss_gated": baseline_rss is not None,
        "snap_count": snap_count,
        "snapshots_taken": bool(snapshots_taken),
        "disk_final": final_disk,
        "disk_bounded": disk_bounded,
        "clean": errors == 0 and not leak and disk_bounded,
        "metrics": obs_registry.snapshot(),
    }
    print(json.dumps(summary), flush=True)
    return 0 if summary["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
