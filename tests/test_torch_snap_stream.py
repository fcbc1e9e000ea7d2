"""The port's streamed snapshot transfer (``snap/stream.py``:
``SnapshotSource``, ``SourceCache``, ``ChunkPuller``) against the JAX
package's.

The chunk chain and the pinned source's meta and chunks are equal in
both packages; the port's puller, verifying on the CPU (the device
route's plain torch version) and on the host route, pulls from a donor
serving either package's source.  A corrupt chunk is rejected and
refetched, never installed; a corruption budget, a stale pin and an
abort hook end the stream with the typed errors; a donor that drops
mid-stream is resumed from the last verified chunk.  Tolerance: exact
(bytes and CRCs).
"""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from etcd_tpu.snap import stream as jstream

from etcd_tpu_torch.obs.metrics import registry as obs_registry
from etcd_tpu_torch.scripts.dist_bench import free_ports
from etcd_tpu_torch.snap import stream as tstream
from etcd_tpu_torch.snap.stream import (
    CHUNK_PATH,
    ChunkPuller,
    ChunkVerifier,
    SnapshotSource,
    SnapStreamError,
    SourceCache,
    StaleSourceError,
    chunk_crcs,
)


def _payload(n=100_000, seed=7) -> bytes:
    return np.random.default_rng(seed).bytes(n)


def _verifiers():
    return [ChunkVerifier(route="host"), ChunkVerifier(device="cpu")]


def test_chunk_chain_equal_to_reference():
    p = _payload(10_000)
    for cb in (1, 100, 1024, 4096, 20_000):
        assert chunk_crcs(p, cb) == jstream.chunk_crcs(p, cb)
    crcs = chunk_crcs(p, 1024)
    assert len(crcs) == 10


def test_snapshot_source_meta_and_chunks_equal_to_reference():
    p = _payload(5000)
    src = SnapshotSource(p, extra={"seq": 42}, chunk_bytes=512)
    ref = jstream.SnapshotSource(p, extra={"seq": 42}, chunk_bytes=512)
    m, mr = src.meta(), ref.meta()
    m.pop("id"), mr.pop("id")  # pin ids are per process, per pin
    assert m == mr
    assert m["size"] == 5000 and m["n_chunks"] == 10 and m["seq"] == 42
    assert [src.chunk(k) for k in range(10)] == \
        [ref.chunk(k) for k in range(10)]
    assert b"".join(src.chunk(k) for k in range(10)) == p
    with pytest.raises(IndexError):
        src.chunk(10)
    assert SnapshotSource(p, chunk_bytes=512).id != src.id


def test_source_cache_keeps_newest_and_expires():
    c = SourceCache(keep=2, ttl_s=60)
    s1 = c.pin(SnapshotSource(b"one", chunk_bytes=4))
    s2 = c.pin(SnapshotSource(b"two", chunk_bytes=4))
    s3 = c.pin(SnapshotSource(b"three", chunk_bytes=4))
    assert c.get(s1.id) is None
    assert c.get(s2.id) is s2 and c.get(s3.id) is s3
    s3.pinned_at -= 120
    assert c.get(s3.id) is None


class _Donor:
    """Tiny chunk server with programmable faults, serving a source of
    either package."""

    def __init__(self, src):
        self.src = src
        self.served: list[int] = []
        self.corrupt_once: set[int] = set()
        self.die_after: int | None = None
        self.stale = False
        donor = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if self.path != CHUNK_PATH:
                    self._reply(404, b"")
                    return
                sid, k = body.decode().split()
                k = int(k)
                if donor.stale or sid != donor.src.id:
                    self._reply(404, b"")
                    return
                if donor.die_after is not None \
                        and len(donor.served) >= donor.die_after:
                    self.close_connection = True
                    self.wfile.close()
                    return
                donor.served.append(k)
                data = donor.src.chunk(k)
                if k in donor.corrupt_once:
                    donor.corrupt_once.discard(k)
                    data = bytes(data[:-1]) + bytes([data[-1] ^ 0xFF])
                self._reply(200, data)

            def _reply(self, code, data):
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                if data:
                    self.wfile.write(data)

        port = free_ports(1)[0]
        self.url = f"http://127.0.0.1:{port}"
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), H)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _pull(donor, meta, **kw) -> bytes:
    puller = ChunkPuller(donor.url, meta, **kw)
    try:
        return puller.run()
    finally:
        puller.close()


def _reject_count() -> float:
    return obs_registry.counter("etcd_snap_install_total",
                                outcome="chunk_reject").get()


@pytest.mark.parametrize("donor_pkg", [jstream, tstream],
                         ids=["reference_donor", "port_donor"])
def test_puller_clean_pull_from_either_package(donor_pkg):
    p = _payload(50_000)
    src = donor_pkg.SnapshotSource(p, chunk_bytes=4096)
    donor = _Donor(src)
    try:
        for v in _verifiers():
            assert _pull(donor, src.meta(), timeout=2.0, window=4,
                         deadline_s=30.0, verifier=v) == p
    finally:
        donor.close()
    assert sorted(donor.served) == sorted(2 * list(range(src.n_chunks)))


@pytest.mark.parametrize("route", ["host", "device"])
def test_puller_rejects_and_refetches_corrupt_chunk(route):
    p = _payload(30_000)
    src = SnapshotSource(p, chunk_bytes=4096)
    donor = _Donor(src)
    donor.corrupt_once = {2, 5}
    before = _reject_count()
    try:
        v = ChunkVerifier(route=route, device="cpu")
        assert _pull(donor, src.meta(), timeout=2.0, window=3,
                     deadline_s=30.0, verifier=v) == p
    finally:
        donor.close()
    assert _reject_count() == before + 2
    assert donor.served.count(2) == 2 and donor.served.count(5) == 2


def test_puller_corruption_budget_aborts():
    src = SnapshotSource(_payload(10_000), chunk_bytes=2048)
    donor = _Donor(src)

    class Always(set):
        def discard(self, k):
            pass

    donor.corrupt_once = Always({1})
    try:
        with pytest.raises(SnapStreamError):
            _pull(donor, src.meta(), timeout=2.0, window=2,
                  max_rejects=3, deadline_s=20.0,
                  verifier=ChunkVerifier(device="cpu"))
    finally:
        donor.close()


def test_puller_stale_pin_aborts_with_stale_error():
    src = SnapshotSource(_payload(8_000), chunk_bytes=2048)
    donor = _Donor(src)
    donor.stale = True
    try:
        with pytest.raises(StaleSourceError):
            _pull(donor, src.meta(), timeout=2.0, deadline_s=20.0,
                  verifier=ChunkVerifier(device="cpu"))
    finally:
        donor.close()


def test_puller_resumes_from_last_verified_after_donor_drop():
    p = _payload(40_000)
    src = SnapshotSource(p, chunk_bytes=4096)
    donor = _Donor(src)
    donor.die_after = 4

    def heal():
        time.sleep(1.5)
        donor.die_after = None

    threading.Thread(target=heal, daemon=True).start()
    try:
        assert _pull(donor, src.meta(), timeout=1.0, window=2,
                     deadline_s=40.0,
                     verifier=ChunkVerifier(device="cpu")) == p
    finally:
        donor.close()
    assert donor.served.count(0) == 1 and donor.served.count(1) == 1


def test_puller_abort_hook_stops_stream():
    src = SnapshotSource(_payload(20_000), chunk_bytes=2048)
    donor = _Donor(src)
    donor.die_after = 0
    stop = threading.Event()
    threading.Timer(0.5, stop.set).start()
    t0 = time.monotonic()
    try:
        with pytest.raises(SnapStreamError):
            _pull(donor, src.meta(), timeout=1.0, deadline_s=60.0,
                  abort=stop.is_set, verifier=ChunkVerifier(device="cpu"))
        assert time.monotonic() - t0 < 10.0
    finally:
        donor.close()


def test_empty_payload_streams_as_empty():
    src = SnapshotSource(b"", chunk_bytes=1024)
    assert src.n_chunks == 0
    donor = _Donor(src)
    try:
        assert _pull(donor, src.meta(), timeout=1.0,
                     verifier=ChunkVerifier(device="cpu")) == b""
    finally:
        donor.close()
