"""Cluster bootstrap via a public etcd discovery URL (reference
discovery/; the port's copy of ``etcd_tpu/discovery``)."""

from .discovery import Discoverer, DiscoveryError

__all__ = ["Discoverer", "DiscoveryError"]
