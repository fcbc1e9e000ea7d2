"""Host utilities (the port's own copies): the etcd error codes, durable
fsync helpers, failpoints, backoff, the wait registry, the tracer, the
CLI's flag helpers and TLS contexts."""
