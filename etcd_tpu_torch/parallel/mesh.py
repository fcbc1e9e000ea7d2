"""The fused data-plane step on one card: WAL-chunk CRC chain verify +
the batched Raft leader pipeline.

The port of ``etcd_tpu/parallel/mesh.py:data_plane_step`` and
``replay_commit_local``.  The mesh-sharded builders of that module are
not ported yet.
"""

from __future__ import annotations

from ..ops.crc_device import chain_verify_device, raw_crc_batch
from ..ops.quorum import maybe_commit_batch
from ..raft.batched import GroupState, replication_round


def replay_commit_local(buf, lens, stored, seed,
                        match, nmembers, committed, term,
                        log_terms, offset):
    """Single-card fused step: returns ``(links_ok, new_committed)``.

    ``buf`` [N, L] uint8 right-aligned record payloads, ``lens`` [N]
    byte lengths, ``stored`` [N] the rolling CRCs recorded in the WAL
    (int64 holding uint32), ``seed`` the chain seed.  The raft tensors
    are the [G, ...] group-batched state of ops/quorum.py.
    """
    raw = raw_crc_batch(buf)
    links_ok = chain_verify_device(seed, stored, raw, lens)
    new_committed = maybe_commit_batch(
        match, nmembers, committed, term, log_terms, offset)
    return links_ok, new_committed


def data_plane_step(buf, lens, stored, seed, state: GroupState,
                    n_new, self_slot, resp_slots, resp_idx, resp_mask):
    """The flagship single-card step: one fused round of

    1. WAL-chunk CRC chain verification (north-star config 1), and
    2. the batched-raft leader pipeline — append proposals, absorb
       msgAppResp progress, advance quorum commit over all G groups
       (north-star config 4; raft/batched.py:replication_round).

    Returns ``(links_ok [N], state', err [G], n_committed [G])``.  On
    CUDA tensors the raw CRC runs in the hand-written kernel.
    """
    raw = raw_crc_batch(buf)
    links_ok = chain_verify_device(seed, stored, raw, lens)
    state, err, ncomm = replication_round(
        state, n_new, self_slot, resp_slots, resp_idx, resp_mask)
    return links_ok, state, err, ncomm
