"""Snapshot transfer: the verifier of streamed snapshot chunks
(``stream.ChunkVerifier``, the port of the part of ``etcd_tpu/snap`` on
the card's path)."""

from .stream import ChunkVerifier

__all__ = ["ChunkVerifier"]
