"""How often a ``torch.profiler`` session records none of the kernels
that another thread launches.

    python -m etcd_tpu_torch.scripts.profiler_sessions [SESSIONS]
    TEARDOWN_CUPTI=1 python -m etcd_tpu_torch.scripts.profiler_sessions

A co-hosted server (``MultiGroupServer``, 10,000 groups x 5, cap 1024)
runs its loop in its own thread, and 8 client threads PUT without pause,
so that thread launches kernels all the time.  After one session of its
own work, as ``chip_smoke.py`` profiles its step first, the main thread
opens and closes ``SESSIONS`` sessions of 0.25 s (CPU and CUDA
activities, as ``cohosted_bench.profile_calls``) and counts the CUDA
kernels and copies each recorded.  Prints one JSON object: the sessions,
how many recorded no kernel, and the least and most kernels and copies
a session.  ``TEARDOWN_CUPTI=1`` makes the profiler tear CUPTI down
after each session; ``chip_smoke.py`` sets it from what this shows.
On the CPU (``device="cpu"``, the tests) the sessions record CPU
activity only, and no kernel.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time

import torch

from .. import default_device
from ..server.multigroup import MultiGroupServer
from ..wire.requests import Request


def _counts(prof) -> tuple[int, int]:
    kernels = copies = 0
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
    return kernels, copies


def main(sessions: int = 30, g: int = 10_000, m: int = 5, cap: int = 1024,
         window_s: float = 0.25, writers: int = 8, device=None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    dev = default_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    x = torch.ones(1 << 16, device=dev)
    with profile(activities=acts):
        for _ in range(20):
            x = x + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    d = tempfile.mkdtemp(prefix="profiler_sessions_")
    s = MultiGroupServer(os.path.join(d, "data"), g=g, m=m, cap=cap,
                         device=dev, snap_count=1 << 40)
    s.start()
    stop = threading.Event()
    errors: list[BaseException] = []

    def writer(w: int) -> None:
        i = 0
        try:
            while not stop.is_set():
                i += 1
                r = s.do(Request(id=(w << 32) + i, method="PUT",
                                 path=f"/w{w}/k{i}", val="v"), timeout=120)
                if r.err is not None:
                    raise r.err
        except BaseException as e:  # reported below
            errors.append(e)

    ts = [threading.Thread(target=writer, args=(w,)) for w in range(writers)]
    got = []
    try:
        for t in ts:
            t.start()
        time.sleep(4 * window_s)
        for _ in range(sessions):
            with profile(activities=acts) as prof:
                time.sleep(window_s)
            got.append(_counts(prof))
    finally:
        stop.set()
        for t in ts:
            t.join()
        s.stop()
        shutil.rmtree(d, ignore_errors=True)
    if errors:
        raise RuntimeError(f"profiler_sessions: a writer failed: "
                           f"{errors[0]!r}")
    kernels = [k for k, _ in got]
    copies = [c for _, c in got]
    return {"teardown_cupti": os.environ.get("TEARDOWN_CUPTI"),
            "sessions": sessions,
            "without_kernels": sum(k == 0 for k in kernels),
            "kernels": [min(kernels), max(kernels)],
            "copies": [min(copies), max(copies)]}


if __name__ == "__main__":
    print(json.dumps(main(*(int(a) for a in sys.argv[1:2]))))
