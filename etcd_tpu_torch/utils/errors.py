"""etcd numeric error vocabulary (reference error/error.go).

100-series command errors, 200 post-form, 300 raft, 400 etcd-internal,
500 client (error.go:68-100); JSON body + HTTP status mapping
(error.go:136-155).
"""

from __future__ import annotations

import json

# command related errors
ECODE_KEY_NOT_FOUND = 100
ECODE_TEST_FAILED = 101
ECODE_NOT_FILE = 102
ECODE_NO_MORE_PEER = 103
ECODE_NOT_DIR = 104
ECODE_NODE_EXIST = 105
ECODE_KEY_IS_PRESERVED = 106
ECODE_ROOT_RONLY = 107
ECODE_DIR_NOT_EMPTY = 108
ECODE_EXISTING_PEER_ADDR = 109

# post form related errors
ECODE_VALUE_REQUIRED = 200
ECODE_PREV_VALUE_REQUIRED = 201
ECODE_TTL_NAN = 202
ECODE_INDEX_NAN = 203
ECODE_VALUE_OR_TTL_REQUIRED = 204
ECODE_TIMEOUT_NAN = 205
ECODE_NAME_REQUIRED = 206
ECODE_INDEX_OR_VALUE_REQUIRED = 207
ECODE_INDEX_VALUE_MUTEX = 208
ECODE_INVALID_FIELD = 209
ECODE_INVALID_FORM = 210

# raft related errors
ECODE_RAFT_INTERNAL = 300
ECODE_LEADER_ELECT = 301

# etcd related errors
ECODE_WATCHER_CLEARED = 400
ECODE_EVENT_INDEX_CLEARED = 401
ECODE_STANDBY_INTERNAL = 402
ECODE_INVALID_ACTIVE_SIZE = 403
ECODE_INVALID_REMOVE_DELAY = 404
# ENOSPC degradation: the member's data disk is full; it
# serves reads but rejects writes until GC frees space (the NOSPACE
# alarm of the reference lineage, as a v2-style numeric code)
ECODE_NO_SPACE = 405
# Overload shedding: the front door's admission control
# rejected the request — a tenant's token bucket / inflight quota or
# a global ceiling is exhausted.  Maps to HTTP 429; the response
# carries Retry-After so well-behaved clients pace instead of
# retry-storming (api/client.py honors it via the shared backoff).
ECODE_OVER_CAPACITY = 406

# client related errors
ECODE_CLIENT_INTERNAL = 500

ERROR_MESSAGES = {
    ECODE_KEY_NOT_FOUND: "Key not found",
    ECODE_TEST_FAILED: "Compare failed",
    ECODE_NOT_FILE: "Not a file",
    ECODE_NO_MORE_PEER: "Reached the max number of peers in the cluster",
    ECODE_NOT_DIR: "Not a directory",
    ECODE_NODE_EXIST: "Key already exists",
    ECODE_KEY_IS_PRESERVED: "The prefix of given key is a keyword in etcd",
    ECODE_ROOT_RONLY: "Root is read only",
    ECODE_DIR_NOT_EMPTY: "Directory not empty",
    ECODE_EXISTING_PEER_ADDR: "Peer address has existed",
    ECODE_VALUE_REQUIRED: "Value is Required in POST form",
    ECODE_PREV_VALUE_REQUIRED: "PrevValue is Required in POST form",
    ECODE_TTL_NAN: "The given TTL in POST form is not a number",
    ECODE_INDEX_NAN: "The given index in POST form is not a number",
    ECODE_VALUE_OR_TTL_REQUIRED: "Value or TTL is required in POST form",
    ECODE_TIMEOUT_NAN: "The given timeout in POST form is not a number",
    ECODE_NAME_REQUIRED: "Name is required in POST form",
    ECODE_INDEX_OR_VALUE_REQUIRED: "Index or value is required",
    ECODE_INDEX_VALUE_MUTEX: "Index and value cannot both be specified",
    ECODE_INVALID_FIELD: "Invalid field",
    ECODE_INVALID_FORM: "Invalid POST form",
    ECODE_RAFT_INTERNAL: "Raft Internal Error",
    ECODE_LEADER_ELECT: "During Leader Election",
    ECODE_WATCHER_CLEARED: "watcher is cleared due to etcd recovery",
    ECODE_EVENT_INDEX_CLEARED: "The event in requested index is outdated and cleared",
    ECODE_STANDBY_INTERNAL: "Standby Internal Error",
    ECODE_INVALID_ACTIVE_SIZE: "Invalid active size",
    ECODE_INVALID_REMOVE_DELAY: "Standby remove delay",
    ECODE_NO_SPACE: "No space on data disk; member is read-only",
    ECODE_OVER_CAPACITY: "Too many requests; shed by admission control",
    ECODE_CLIENT_INTERNAL: "Client Internal Error",
}


class EtcdError(Exception):
    """Carries the numeric code, cause, and store index
    (reference error/error.go:102-130)."""

    def __init__(self, error_code: int, cause: str = "", index: int = 0):
        self.error_code = error_code
        self.message = ERROR_MESSAGES.get(error_code, "unknown error")
        self.cause = cause
        self.index = index
        super().__init__(f"{self.message} ({cause})")

    def to_json(self) -> str:
        body = {
            "errorCode": self.error_code,
            "message": self.message,
            "index": self.index,
        }
        if self.cause:
            body["cause"] = self.cause
        return json.dumps(body)

    def http_status(self) -> int:
        """Reference error/error.go:139-151."""
        if self.error_code == ECODE_KEY_NOT_FOUND:
            return 404
        if self.error_code == ECODE_NO_SPACE:
            return 507  # Insufficient Storage
        if self.error_code == ECODE_OVER_CAPACITY:
            return 429  # Too Many Requests
        if self.error_code in (ECODE_NOT_FILE, ECODE_DIR_NOT_EMPTY):
            return 403
        if self.error_code in (ECODE_TEST_FAILED, ECODE_NODE_EXIST):
            return 412
        if self.error_code // 100 == 3:
            return 500
        return 400


class EtcdNoSpace(EtcdError):
    """Typed ENOSPC degradation signal: a WAL/snapshot
    writer could not allocate space.  Servers catching this enter a
    read-only NOSPACE mode (serve lease/ReadIndex GETs, reject
    writes with :data:`ECODE_NO_SPACE`) and recover by probing the
    disk with backoff — never by crash-looping, and NEVER by
    retrying a failed fsync (that path is fail-stop, see
    utils/faults.fail_stop)."""

    def __init__(self, cause: str = "", index: int = 0):
        super().__init__(ECODE_NO_SPACE, cause, index)


class EtcdOverCapacity(EtcdError):
    """Typed admission-control rejection: the front door shed this
    request (tenant token bucket / inflight quota or a global ceiling
    exhausted).  ``retry_after`` is the server's pacing hint in
    seconds; the HTTP layer surfaces it as a ``Retry-After`` header on
    the 429 so shedding is an *answer*, never a timeout."""

    def __init__(self, cause: str = "", index: int = 0,
                 retry_after: float = 1.0):
        super().__init__(ECODE_OVER_CAPACITY, cause, index)
        self.retry_after = max(0.0, float(retry_after))
