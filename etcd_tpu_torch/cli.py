"""CLI entry point (reference main.go; the port's copy of the co-hosted
mode of ``etcd_tpu/cli.py``): etcd-compatible flags with ETCD_* env
fallback.

Run as ``python -m etcd_tpu_torch.cli --cohosted-groups G
--cohosted-members M --data-dir DIR``: G raft groups of M members, their
consensus batched on the card, behind the standard /v2 client API
(namespace = first path segment).

The device is CUDA; ``ETCD_TORCH_DEVICE`` names another (``cpu`` runs
the plain torch versions on the host, for tests).  Without CUDA and
without that variable the CLI exits 1 with the error.

Not ported yet, each exiting 2 with "not ported yet": the classic
single-group mode (``--cohosted-groups 0``), ``--cohosted-mesh-devices
N > 0``, ``--dist-slot``, ``--proxy`` and ``--frontdoor on`` (the
front door).  The port's ``--frontdoor`` therefore defaults to ``off``,
where the reference's defaults to ``on``; the threaded server answers.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
import urllib.parse

from . import __version__, default_device
from .api import make_client_handler, serve
from .server import DEFAULT_SNAP_COUNT
from .utils.flags import (
    DEPRECATED_FLAGS,
    IGNORED_FLAGS,
    PROXY_VALUES,
    PROXY_VALUE_OFF,
    parse_cors,
    parse_ip_address_port,
    set_flags_from_env,
    urls_from_flags,
)
from .utils.transport import TLSInfo, new_listener_context

log = logging.getLogger(__name__)

#: the device the server runs on (default: CUDA)
DEVICE_ENV = "ETCD_TORCH_DEVICE"

#: exit status of a mode or option that is not ported yet
NOT_PORTED_EXIT = 2


def build_parser() -> argparse.ArgumentParser:
    """Flag registry (reference main.go:27-99), trimmed to the co-hosted
    mode and the flags that name a mode not ported yet."""
    p = argparse.ArgumentParser(
        prog="etcd-tpu-torch", add_help=True,
        description="etcd on the card: highly-available key value store")
    p.add_argument("--name", default="default",
                   help="Unique human-readable name for this node")
    p.add_argument("--data-dir", default="",
                   help="Path to the data directory")
    p.add_argument("--discovery", default="",
                   help="Discovery service used to bootstrap the cluster")
    p.add_argument("--snapshot-count", type=int,
                   default=DEFAULT_SNAP_COUNT,
                   help="Number of committed transactions to trigger a "
                        "snapshot")
    p.add_argument("--version", action="store_true",
                   help="Print the version and exit")
    p.add_argument("--initial-cluster",
                   default="default=http://localhost:2380,"
                           "default=http://localhost:7001",
                   help="Initial cluster configuration for bootstrapping")
    p.add_argument("--initial-cluster-state", default="new",
                   choices=["new"], help="Initial cluster state")
    p.add_argument("--advertise-peer-urls",
                   default="http://localhost:2380,http://localhost:7001")
    p.add_argument("--advertise-client-urls",
                   default="http://localhost:2379,http://localhost:4001")
    p.add_argument("--listen-peer-urls",
                   default="http://localhost:2380,http://localhost:7001")
    p.add_argument("--listen-client-urls",
                   default="http://localhost:2379,http://localhost:4001")
    p.add_argument("--cors", default="",
                   help="Comma-separated white list of origins for CORS")
    p.add_argument("--frontdoor",
                   default=os.environ.get("ETCD_FRONTDOOR", "off"),
                   choices=["on", "off"],
                   help="'off' (the default here) serves the client API "
                        "from the threaded server; the event-driven "
                        "front door ('on') is not ported yet")
    p.add_argument("--proxy", default=PROXY_VALUE_OFF,
                   choices=list(PROXY_VALUES))
    p.add_argument("--ca-file", default="")
    p.add_argument("--cert-file", default="")
    p.add_argument("--key-file", default="")
    p.add_argument("--peer-ca-file", default="")
    p.add_argument("--peer-cert-file", default="")
    p.add_argument("--peer-key-file", default="")
    p.add_argument("--storage-backend", default="auto",
                   choices=["auto", "tpu", "host"],
                   help="Replay/hash backend: tpu replays the WAL on the "
                        "card's stream lane; auto lets the measured "
                        "router choose; host never touches the card for "
                        "replay or the snapshot hash")
    p.add_argument("--cohosted-groups", type=int, default=0,
                   help="Run the co-hosted multi-group server: N raft "
                        "groups batched on the card behind one /v2/keys "
                        "endpoint (namespace = first path segment)")
    p.add_argument("--cohosted-members", type=int, default=3,
                   help="Members per co-hosted group (default 3)")
    p.add_argument("--cohosted-mesh-devices", type=int, default=0,
                   help="Shard the co-hosted group batch over N local "
                        "devices (not ported yet; 0 = single device)")
    p.add_argument("--dist-slot", type=int, default=-1,
                   help="The distributed multi-group server's member "
                        "slot (not ported yet; -1 = off)")
    # v0.4.6 back-compat (main.go:87-98); values are validated as
    # strict IP:port (pkg/flags/ipaddressport.go semantics)
    p.add_argument("--addr", default=None, type=parse_ip_address_port,
                   help="DEPRECATED: Use --advertise-client-urls instead.")
    p.add_argument("--bind-addr", default=None,
                   type=parse_ip_address_port,
                   help="DEPRECATED: Use --listen-client-urls instead.")
    p.add_argument("--peer-addr", default=None,
                   type=parse_ip_address_port,
                   help="DEPRECATED: Use --advertise-peer-urls instead.")
    p.add_argument("--peer-bind-addr", default=None,
                   type=parse_ip_address_port,
                   help="DEPRECATED: Use --listen-peer-urls instead.")
    for f in IGNORED_FLAGS:
        p.add_argument(f"--{f}", nargs="?", const="", default=None,
                       help=argparse.SUPPRESS)
    for f in DEPRECATED_FLAGS:
        p.add_argument(f"--{f}", default=None, help=argparse.SUPPRESS)
    return p


def _explicit_flags(argv: list[str]) -> set[str]:
    out = set()
    for a in argv:
        if a.startswith("--"):
            out.add(a[2:].split("=", 1)[0])
        elif a.startswith("-") and len(a) > 1:
            out.add(a[1:].split("=", 1)[0])
    return out


def _not_ported(what: str, where: str) -> int:
    print(f"etcd_tpu_torch: {what} is not ported yet (ROADMAP {where})",
          file=sys.stderr)
    return NOT_PORTED_EXIT


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s: %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    parser = build_parser()
    args = parser.parse_args(argv)
    explicit = _explicit_flags(argv)

    if args.version:
        print("etcd version", __version__)
        return 0

    for f in DEPRECATED_FLAGS:
        if getattr(args, f.replace("-", "_")) is not None:
            print(f'flag "--{f}" is no longer supported.', file=sys.stderr)
            return 1
    for f in IGNORED_FLAGS:
        if getattr(args, f.replace("-", "_"), None) is not None:
            log.warning('flag "--%s" is no longer supported - ignoring.', f)

    set_flags_from_env(parser, args, explicit)

    if args.proxy != PROXY_VALUE_OFF:
        return _not_ported("--proxy", "A, the proxy")
    if args.dist_slot >= 0:
        return _not_ported("--dist-slot", "A6, the distributed server")
    if args.cohosted_groups <= 0:
        return _not_ported("the classic single-group mode",
                           "A, the single-group server")
    if args.cohosted_mesh_devices:
        return _not_ported("--cohosted-mesh-devices",
                           "A10, the sharded step")
    if args.frontdoor == "on":
        return _not_ported("--frontdoor on", "A, the front door")
    try:
        device = default_device(os.environ.get(DEVICE_ENV) or None)
    except RuntimeError as e:
        print(f"etcd_tpu_torch: {e} (or set {DEVICE_ENV})",
              file=sys.stderr)
        return 1
    return start_multigroup(args, explicit, device)


def start_multigroup(args, explicit: set[str], device) -> int:
    """Co-hosted multi-group mode: G groups' consensus runs as one
    batched data plane on ``device`` behind the standard client API
    (server/multigroup.py; no reference counterpart, the reference is
    one group per process)."""
    from .server.multigroup import MultiGroupServer

    data_dir = args.data_dir or f"{args.name}_multigroup_data"
    os.makedirs(data_dir, mode=0o700, exist_ok=True)
    client_tls = TLSInfo(args.cert_file, args.key_file, args.ca_file)
    acurls = urls_from_flags(args, "advertise_client_urls", "addr",
                             explicit, client_tls.empty())
    s = MultiGroupServer(
        data_dir, g=args.cohosted_groups, m=args.cohosted_members,
        name=args.name, snap_count=args.snapshot_count,
        storage_backend=args.storage_backend,
        client_urls=list(acurls), device=device)
    s.start()
    cors = parse_cors(args.cors) if args.cors else None
    lcurls = urls_from_flags(args, "listen_client_urls", "bind_addr",
                             explicit, client_tls.empty())
    for u in lcurls:
        host, port = _split_hostport(u)
        serve(make_client_handler(s, cors=cors), host, port,
              new_listener_context(client_tls))
        log.info("Listening for client requests on %s "
                 "(%d co-hosted groups x %d members on %s)",
                 u, args.cohosted_groups, args.cohosted_members, device)

    threading.Event().wait()  # pragma: no cover
    return 0


def _split_hostport(u: str) -> tuple[str, int]:
    parsed = urllib.parse.urlsplit(u)
    return parsed.hostname or "", parsed.port or 0


if __name__ == "__main__":
    sys.exit(main())
