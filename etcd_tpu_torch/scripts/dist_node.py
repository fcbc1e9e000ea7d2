"""Standalone distributed-multigroup node (one member slot per
process): the runner behind the port's kill -9 test and the dist phase
of ``chip_smoke.py``.

Usage:
  python -m etcd_tpu_torch.scripts.dist_node --data-dir D --slot N \
      --peers http://127.0.0.1:7700,http://127.0.0.1:7701,... \
      [--groups 8] [--cap 64] [--storage-backend auto|tpu|host] \
      [--bootstrap]

The engine runs on CUDA; ``ETCD_TORCH_DEVICE`` names another device
(``cpu`` for tests).  Without CUDA and without that variable the node
exits non-zero naming CUDA.

Prints one JSON line ``{"slot", "fresh", "restart_s", "lane",
"raw_crc_launches", "raw_crc_largest", "device"}`` once the server is
built (its restart seconds, the replay lane the restart took, the
launches of the raw-CRC kernel the process made so far and the largest
[N, L] batch among them), then "READY" once serving
(and, with --bootstrap, once this node leads every group).  Writes
arrive via POST /mraft/propose (a marshaled wire Request); peers
exchange batched frames on /mraft.
"""

import argparse
import json
import os
import sys
import time

from etcd_tpu_torch.server.distserver import DistServer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--slot", type=int, required=True)
    ap.add_argument("--peers", required=True,
                    help="comma-separated slot-indexed base URLs")
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--cap", type=int, default=64)
    ap.add_argument("--storage-backend", default="auto",
                    choices=["auto", "tpu", "host"],
                    help="restart replay backend: tpu replays the WAL "
                         "on the card's stream lane")
    ap.add_argument("--max-batch-ents", type=int, default=32)
    ap.add_argument("--pipeline-depth", type=int, default=8,
                    help="max in-flight append frames per peer "
                         "(1 = lockstep-equivalent)")
    ap.add_argument("--coalesce-us", type=int, default=2000)
    ap.add_argument("--lease-ticks", type=int, default=30,
                    help="leader-lease length in ticks for "
                         "linearizable reads (< election - drift; "
                         "0 = lease off, ReadIndex-only)")
    ap.add_argument("--snap-count", type=int, default=None,
                    help="applies between snapshots (snapshot + "
                         "segment GC cadence; default 10000)")
    ap.add_argument("--bootstrap", action="store_true",
                    help="campaign for every group before READY")
    ap.add_argument("--roles", type=int, default=0, metavar="S",
                    help="role-split topology (not ported yet)")
    args = ap.parse_args()

    if args.roles:
        print("dist_node: --roles is not ported yet", file=sys.stderr)
        sys.exit(2)

    from etcd_tpu_torch.ops.crc_cuda import raw_crc_cuda
    from etcd_tpu_torch.wal.backend_policy import get_policy

    t0 = time.perf_counter()
    srv = DistServer(args.data_dir, slot=args.slot,
                     peer_urls=args.peers.split(","),
                     g=args.groups, cap=args.cap,
                     max_batch_ents=args.max_batch_ents,
                     tick_interval=0.05, post_timeout=2.0,
                     election=60,
                     pipeline_depth=args.pipeline_depth,
                     coalesce_us=args.coalesce_us,
                     snap_count=args.snap_count,
                     lease_ticks=args.lease_ticks,
                     storage_backend=args.storage_backend,
                     device=os.environ.get("ETCD_TORCH_DEVICE") or None)
    restart_s = time.perf_counter() - t0
    decision = get_policy().decisions.get("restart") or {}
    print(json.dumps({
        "slot": args.slot, "fresh": srv.fresh,
        "restart_s": None if srv.fresh else restart_s,
        "lane": None if srv.fresh else decision.get("route"),
        "raw_crc_launches": raw_crc_cuda.launches,
        "raw_crc_largest": list(raw_crc_cuda.largest),
        "device": str(srv.device)}), flush=True)
    srv.start()

    # black-box dump on the way down: SIGTERM (the bench's
    # teardown signal) or a crash writes the flight ring to
    # ETCD_FLIGHT_DIR (default: alongside the data dir) — forensics
    # survive the process
    from etcd_tpu_torch.obs.flight import install_crash_dump

    install_crash_dump(srv.flight,
                       os.environ.get("ETCD_FLIGHT_DIR")
                       or os.path.join(args.data_dir,
                                       "trace_artifacts"))

    # SIGUSR1 dumps the tracer span table to stdout (profiling a real
    # cluster process from outside without stopping it)
    import signal as _signal

    prof = None
    if os.environ.get("ETCD_PROFILE_FRAMES"):
        # function-level attribution for the peer-frame hot path:
        # wrap handle_frame in a cProfile that accumulates across
        # calls.  cProfile is strictly single-tool-at-a-time, so a
        # lock serializes concurrent handler threads (this is a
        # diagnostic mode; the serialization is part of the price)
        import cProfile
        import threading as _threading

        prof = cProfile.Profile()
        _prof_lock = _threading.Lock()
        inner = srv.handle_frame

        def profiled(data):
            with _prof_lock:
                prof.enable()
                try:
                    return inner(data)
                finally:
                    prof.disable()

        srv.handle_frame = profiled

    def _dump(signum, frame):
        from etcd_tpu_torch.utils.trace import tracer

        print("SPANS " + tracer.snapshot_json().decode(), flush=True)
        if prof is not None:
            import io
            import pstats

            s = io.StringIO()
            pstats.Stats(prof, stream=s).sort_stats(
                "cumulative").print_stats(25)
            print("PROFILE-BEGIN", flush=True)
            print(s.getvalue(), flush=True)
            print("PROFILE-END", flush=True)

    _signal.signal(_signal.SIGUSR1, _dump)
    if args.bootstrap:
        deadline = time.time() + 60.0
        while time.time() < deadline:
            lead = srv.mr.is_leader()
            if lead.all():
                break
            srv._campaign(~lead)
            time.sleep(0.3)
    print("READY", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
