"""Verification of a streamed snapshot's chunks (the port of
``ChunkVerifier`` from ``etcd_tpu/snap/stream.py``).

A snapshot streams in fixed-size chunks, each carrying a rolling
CRC32C chained across chunks: ``crcs[k] = update(crcs[k-1], chunk_k)``
from 0, the WAL record chain's form.  Given its predecessor's *stored*
value every chunk verifies on its own, so a contiguous run of received
chunks verifies in one batch: the GF(2) seed-stitched device form
(``ops/crc_device.inject_seeds``, then one raw-CRC kernel pass and a
compare), or the host's seedable digest.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device, native
from ..ops.crc_device import (
    chain_links_injected,
    inject_seeds,
    raw_crc_batch,
    u32_tensor,
)


class ChunkVerifier:
    """Rolling-chain verification of received chunks.

    ``route="device"`` (also what ``route=None`` picks) is the
    seed-stitched batch on ``default_device(device)``: CUDA unless the
    caller passes ``device="cpu"``, raising without CUDA.
    ``route="host"`` is the host digest, one native CRC per chunk.
    """

    def __init__(self, route: str | None = None, device=None):
        route = "device" if route is None else route
        if route not in ("host", "device"):
            raise ValueError(f"unknown verify route {route!r}")
        self.route = route
        self.device = default_device(device) if route == "device" else None

    def verify(self, chunks: list[bytes], prevs: list[int],
               stored: list[int]) -> list[bool]:
        """Per-chunk verdicts for ``update(prevs[i], chunks[i]) ==
        stored[i]``.  Chunks are independent given their predecessors'
        STORED values (the chain induction), so the device form
        verifies a whole contiguous run in one batch."""
        if not chunks:
            return []
        if self.route == "host":
            return [native.crc32c_update(p, c) == s
                    for c, p, s in zip(chunks, prevs, stored)]
        lens = np.asarray([len(c) for c in chunks], np.int64)
        width = int(lens.max()) + 4
        rows = np.zeros((len(chunks), width), np.uint8)
        for i, c in enumerate(chunks):
            rows[i, width - len(c):] = np.frombuffer(c, np.uint8)
        inject_seeds(rows, lens, np.asarray(prevs, np.uint32))
        ok = chain_links_injected(
            raw_crc_batch(torch.from_numpy(rows).to(self.device)),
            u32_tensor(stored, self.device))
        return [bool(x) for x in ok.cpu()]
