"""Batched quorum commit-index computation (port of
``etcd_tpu/ops/quorum.py``).

The reference computes the commit index by sorting the match indices
and taking the q-th largest, once, for one group (raft/raft.go:248-258).
Here the same order statistic runs for every co-hosted group at once:
one sort along the member axis of a ``[G, M]`` match matrix.

``maybe_commit_batch`` reproduces raft/log.go:88-95's guard: the new
commit index must exceed the current one AND the entry at that index
must carry the current term.
"""

from __future__ import annotations

import numpy as np
import torch


def commit_index_batch(match: torch.Tensor,
                       nmembers: torch.Tensor) -> torch.Tensor:
    """Quorum commit candidate per group: int32 [G].

    ``match`` [G, M] per-member match indices (unused member slots
    must hold 0); ``nmembers`` [G] live member counts.  Quorum size is
    ``n//2 + 1``; the candidate is the q-th largest live match value.
    """
    srt = torch.sort(match, dim=1, descending=True).values
    q = nmembers // 2 + 1
    return torch.gather(srt, 1, (q - 1).to(torch.int64)[:, None])[:, 0]


def maybe_commit_batch(match: torch.Tensor, nmembers: torch.Tensor,
                       committed: torch.Tensor, term: torch.Tensor,
                       log_terms: torch.Tensor,
                       offset: torch.Tensor) -> torch.Tensor:
    """New commit index per group: int32 [G].

    ``log_terms`` [G, CAP] is the term of entry (offset + slot);
    ``offset`` [G] the compaction offset.  Commits advance only when the
    candidate index's entry term equals the leader's current term.
    """
    mci = commit_index_batch(match, nmembers)
    cap = log_terms.shape[1]
    slot = torch.clamp(mci - offset, 0, cap - 1)
    t_at = torch.gather(log_terms, 1, slot.to(torch.int64)[:, None])[:, 0]
    ok = (mci > committed) & (t_at == term)
    return torch.where(ok, mci, committed)


def quorum_basis(ack_t0: np.ndarray, members: np.ndarray,
                 nmembers: np.ndarray, slot: int,
                 now: float) -> np.ndarray:
    """Read-quorum time basis per group: float64 [G].

    The lease/ReadIndex analog of :func:`commit_index_batch`: the same
    q-th-largest order statistic over the member axis, applied to the
    SEND times of the newest matched acks.  ``ack_t0`` [M, G], ``members``
    [G, M] the live-membership mask; this host's own slot counts as
    ``now``.  Host numpy by design: M is tiny and the inputs are
    wall-clock floats produced on host threads.
    """
    v = np.where(members, ack_t0.T, -np.inf)          # [G, M]
    v[:, slot] = np.where(members[:, slot], now, -np.inf)
    srt = np.sort(v, axis=1)[:, ::-1]                 # descending
    q = np.asarray(nmembers) // 2 + 1
    return np.take_along_axis(srt, (q - 1)[:, None], axis=1)[:, 0]
