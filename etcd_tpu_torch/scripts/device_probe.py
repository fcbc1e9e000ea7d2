"""Bounded device-init probe: spawns a child that initializes CUDA and
reports the device names; the parent gives it a deadline.  The port of
``scripts/device_probe.py``.

It answers the question that matters before committing a long run to
the card: can a fresh process bring up a CUDA context right now?  A
child stuck in driver init is terminated, then killed, so it never
outlives the probe.

    python -m etcd_tpu_torch.scripts.device_probe [TIMEOUT_S]  (default 120)

Prints one JSON line {"outcome": "ok"|"hang"|"error", ...}; exit 0
only on "ok", which needs at least one CUDA device up (the reference
requires its backend to be "tpu").
"""

from __future__ import annotations

import json
import multiprocessing as mp
import queue
import sys
import time


def _probe(q):
    try:
        import torch

        torch.cuda.init()
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        q.put(("ok", ",".join(names), len(names)))
    except Exception as e:
        q.put(("error", repr(e)[:200], 0))


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    budget = float(argv[0]) if argv else 120.0
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_probe, args=(q,), daemon=True)
    t0 = time.time()
    p.start()
    # read the queue before joining the child (a join first can wait on
    # the child's queue feeder); poll so a dead child ends the wait
    got = None
    while got is None and time.time() - t0 < budget:
        try:
            got = q.get(timeout=0.5)
        except queue.Empty:
            if not p.is_alive():
                try:  # its last words may still be in the pipe
                    got = q.get(timeout=10)
                except queue.Empty:
                    break
    if got is None and p.is_alive():
        p.terminate()
        p.join(5)
        if p.is_alive():
            # a child stuck in uninterruptible native init survives
            # SIGTERM; it must not outlive the probe
            p.kill()
            p.join(5)
        print(json.dumps({"outcome": "hang", "budget_s": budget}))
        return 1
    p.join(10)
    if got is None:
        print(json.dumps({"outcome": "error",
                          "detail": "child died silently"}))
        return 1
    kind, detail, count = got
    print(json.dumps({"outcome": kind, "devices": detail,
                      "count": count,
                      "seconds": round(time.time() - t0, 1)}))
    return 0 if kind == "ok" and count > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
