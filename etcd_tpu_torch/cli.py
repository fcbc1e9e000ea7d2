"""CLI entry point (reference main.go; the port's copy of
``etcd_tpu/cli.py``): etcd-compatible flags with ETCD_* env fallback;
etcd mode or proxy mode.

Run as ``python -m etcd_tpu_torch.cli --name n0 --initial-cluster
n0=http://...,n1=http://...,n2=http://... --data-dir DIR`` for the
classic single-group server (reference startEtcd): one Raft group
replicated over the members of ``--initial-cluster``, peers on /raft,
the v2 client API on the client URLs.  Or as ``--cohosted-groups G
--cohosted-members M``: G raft groups of M members, their consensus
batched on the card, behind the standard /v2 client API (namespace =
first path segment).  Or as ``--dist-slot N --dist-peers
URL0,URL1,URL2 [--cohosted-groups G]``: this process is member slot N
of G groups whose other members run on the hosts named by
``--dist-peers`` (server/distserver.py).  ``--proxy on|readonly``
runs the stateless proxy over the cluster's URLs (or the ones
``--discovery`` names); ``--discovery URL`` bootstraps the classic
cluster from a discovery registry.

Every tier's client URLs serve through the event-driven front door
(``server/frontdoor.py``) unless ``--frontdoor off`` (or
``ETCD_FRONTDOOR=off``) asks for the threaded server; TLS listeners
fall back to the threaded server, as in the reference.

The device is CUDA; ``ETCD_TORCH_DEVICE`` names another (``cpu`` runs
the plain torch versions on the host, for tests).  Without CUDA and
without that variable the server modes exit 1 with the error; the
proxy needs no device.  The classic server's restart replays its WAL
and hashes its snapshot on that device (``--storage-backend``).
``--cohosted-mesh-devices N`` / ``--dist-mesh-devices N`` split the
group batch over the first N local devices (the CUDA devices; on the
CPU, its 8 virtual devices, ``parallel.mesh.VIRTUAL_CPU_DEVICES``).

``--dist-slot N --dist-roles S`` serves the slot as a supervised family
of processes (``server/roles.py``): a stateless ingest on the client
port, an apply/watch worker on client port + m (m hosts) and S serving
shards peering on peer port + m*s.  The supervisor resolves no device;
the shards inherit ``ETCD_TORCH_DEVICE`` and run on CUDA unless it
names another device.  Each shard's groups get the log the
single-process slot gets (``ROLE_SHARD_CAP`` slots a group).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
import urllib.parse

from . import __version__, default_device
from .api import make_client_handler, make_peer_handler, serve
from .api.proxy import NewProxyHandler
from .server import (
    Cluster,
    DEFAULT_SNAP_COUNT,
    ServerConfig,
    new_server,
)
from .utils.flags import (
    DEPRECATED_FLAGS,
    IGNORED_FLAGS,
    PROXY_VALUES,
    PROXY_VALUE_OFF,
    PROXY_VALUE_READONLY,
    parse_cors,
    parse_ip_address_port,
    set_flags_from_env,
    urls_from_flags,
)
from .utils.transport import TLSInfo, new_listener_context

log = logging.getLogger(__name__)

#: the device the server runs on (default: CUDA)
DEVICE_ENV = "ETCD_TORCH_DEVICE"

#: log slots a group on a ``--dist-roles`` shard: ``DistServer``'s
#: default, which the single-process ``--dist-slot`` serves.  The
#: reference's role mode passes no cap, so adding ``--dist-roles`` cut
#: every group's log to the role parser's 64 slots; a burst of more
#: writes than that on one group then overflows the log, and the
#: proposals that never fit are dropped after 50 rounds.
ROLE_SHARD_CAP = 1024


def build_parser() -> argparse.ArgumentParser:
    """Flag registry (reference main.go:27-99)."""
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
                   default=os.environ.get("ETCD_FRONTDOOR", "on"),
                   choices=["on", "off"],
                   help="Serve the client API through the event-"
                        "driven front door (admission control, "
                        "per-tenant quotas, 50k-connection scale). "
                        "'off' falls back to the threaded server")
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
                        "endpoint (namespace = first path segment). 0 = "
                        "classic single-group mode")
    p.add_argument("--cohosted-members", type=int, default=3,
                   help="Members per co-hosted group (default 3)")
    p.add_argument("--cohosted-mesh-devices", type=int, default=0,
                   help="Shard the co-hosted group batch over the "
                        "first N local devices (--cohosted-groups "
                        "must divide by the mesh's group axis; 0 = "
                        "single device)")
    p.add_argument("--dist-slot", type=int, default=-1,
                   help="Run the DISTRIBUTED multi-group server as "
                        "member slot N of --dist-peers: each host "
                        "owns one member of every co-hosted group, "
                        "rounds exchange batched frames over HTTP "
                        "(-1 = off)")
    p.add_argument("--dist-peers", default="",
                   help="Comma-separated slot-indexed peer base URLs "
                        "for --dist-slot mode (this host's own slot "
                        "included)")
    p.add_argument("--dist-mesh-devices", type=int, default=0,
                   help="Shard this host's group batch over its first "
                        "N local devices (intra-host tier composed "
                        "under the cross-host tier; --cohosted-groups "
                        "must divide by the mesh's group axis; 0 = "
                        "single device)")
    # default 60 ticks (3s at the 0.05s tick): wide enough for every
    # supported host count's stratified bands; start_dist checks it
    # against the actual --dist-peers count (the DistMember clamp
    # would silently stretch a too-small value)
    p.add_argument("--dist-election-ticks", type=int, default=60,
                   help="Election timeout in ticks for --dist-slot "
                        "mode; must be >= the number of --dist-peers "
                        "hosts so per-slot election bands stay "
                        "disjoint")
    # lease band: start_dist checks the actual values the same way
    # DistServer will (lease < election - drift)
    p.add_argument("--dist-lease-ticks", type=int, default=30,
                   help="Leader-lease length in ticks for "
                        "linearizable reads (must be < "
                        "--dist-election-ticks minus the clock-"
                        "drift margin; 0 disables the lease: every "
                        "linearizable read then takes the batched "
                        "ReadIndex confirmation)")
    p.add_argument("--dist-pipeline-depth", type=int, default=8,
                   help="Max in-flight append frames per peer "
                        "(windowed replication pipeline; 1 = "
                        "lockstep-equivalent, one frame per peer at "
                        "a time; >4 adds a second striped "
                        "connection per peer)")
    p.add_argument("--dist-coalesce-us", type=int, default=2000,
                   help="Adaptive drain cadence: a batch flushes "
                        "when full (entries/bytes) or this many "
                        "microseconds after its first proposal, "
                        "whichever first")
    p.add_argument("--dist-roles", type=int, default=0, metavar="S",
                   help="Compartmentalized serving for --dist-slot "
                        "mode: supervise a stateless ingest, an "
                        "apply/watch worker and S serving-shard "
                        "processes on this host instead of one "
                        "in-process server (--cohosted-groups must "
                        "divide by S; 0 = single process)")
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

    cluster = Cluster()
    if args.discovery:
        # temporary self-only cluster until discovery completes
        # (reference main.go:253-275)
        apurls = urls_from_flags(args, "advertise_peer_urls", "peer_addr",
                                 explicit)
        cluster.set_from_string(
            ",".join(f"{args.name}={u}" for u in apurls))
    else:
        cluster.set_from_string(args.initial_cluster)

    if args.proxy != PROXY_VALUE_OFF:
        return start_proxy(args, cluster, explicit)
    if args.dist_slot >= 0 and args.dist_roles:
        # the supervisor makes no CUDA context: its shard processes
        # resolve the device themselves (server/roles.py)
        return start_dist(args, explicit, None)
    try:
        device = default_device(os.environ.get(DEVICE_ENV) or None)
    except RuntimeError as e:
        print(f"etcd_tpu_torch: {e} (or set {DEVICE_ENV})",
              file=sys.stderr)
        return 1
    if args.dist_slot >= 0:
        return start_dist(args, explicit, device)
    if args.cohosted_groups > 0:
        return start_multigroup(args, explicit, device)
    return start_etcd(args, cluster, explicit, device)


def start_dist(args, explicit: set[str], device) -> int:
    """Distributed multi-group mode: this process is ONE member slot
    of every co-hosted group, its consensus state on ``device``; peers
    listed in --dist-peers carry the other slots
    (server/distserver.py).  The standard /v2 client API serves from
    the local replica; writes route to group leaders."""
    from .server.distserver import DistServer

    peers = [u.strip() for u in args.dist_peers.split(",") if u.strip()]
    if len(peers) < 2 or not (0 <= args.dist_slot < len(peers)):
        log.error("dist mode needs --dist-peers with >=2 slot-indexed "
                  "URLs and --dist-slot within range")
        return 1
    if args.dist_election_ticks < len(peers):
        # the distmember election>=m clamp made mechanical at the
        # config surface: refuse rather than silently stretching the
        # operator's number
        log.error("--dist-election-ticks=%d is below the host count "
                  "%d: %d disjoint per-slot election bands cannot "
                  "fit in [%d, %d); pass at least %d",
                  args.dist_election_ticks, len(peers), len(peers),
                  args.dist_election_ticks,
                  2 * args.dist_election_ticks, len(peers))
        return 1
    if args.dist_lease_ticks > 0:
        from .server.readindex import lease_drift_ticks

        eff = max(args.dist_election_ticks, len(peers))
        if args.dist_lease_ticks >= eff - lease_drift_ticks(eff):
            # a lease at or past election - drift can serve reads
            # after a new leader commits (DistServer re-raises it)
            log.error("--dist-lease-ticks=%d must be strictly below "
                      "--dist-election-ticks minus the clock-drift "
                      "margin (%d - %d); pass a smaller lease or 0 "
                      "to disable lease reads",
                      args.dist_lease_ticks, eff,
                      lease_drift_ticks(eff))
            return 1
    data_dir = args.data_dir or f"{args.name}_dist{args.dist_slot}_data"
    os.makedirs(data_dir, mode=0o700, exist_ok=True)
    g = args.cohosted_groups or 64
    if args.dist_roles:
        return _start_dist_roles(args, explicit, peers, data_dir, g)
    client_tls = TLSInfo(args.cert_file, args.key_file, args.ca_file)
    acurls = urls_from_flags(args, "advertise_client_urls", "addr",
                             explicit, client_tls.empty())
    try:
        mesh = _local_mesh(args.dist_mesh_devices, g, device)
    except ValueError as e:
        log.error("--dist-mesh-devices: %s", e)
        return 1
    peer_tls = TLSInfo(args.peer_cert_file, args.peer_key_file,
                       args.peer_ca_file)
    try:
        # member identity folds the slot in: hosts commonly share a
        # --name (the default!), and identical names would collapse
        # to one sha1 id whose registry entries overwrite each other
        s = DistServer(data_dir, slot=args.dist_slot, peer_urls=peers,
                       g=g, name=f"{args.name}-{args.dist_slot}",
                       snap_count=args.snapshot_count,
                       election=args.dist_election_ticks,
                       storage_backend=args.storage_backend,
                       client_urls=list(acurls), mesh=mesh,
                       peer_tls=peer_tls if not peer_tls.empty()
                       else None,
                       pipeline_depth=args.dist_pipeline_depth,
                       coalesce_us=args.dist_coalesce_us,
                       lease_ticks=args.dist_lease_ticks,
                       device=device)
    except ValueError as e:
        log.error("%s", e)
        return 1
    s.start()
    # flight-recorder crash dump: SIGTERM or an unhandled crash writes
    # the black-box ring next to the data dir (or ETCD_FLIGHT_DIR)
    from .obs.flight import install_crash_dump

    install_crash_dump(s.flight,
                       os.environ.get("ETCD_FLIGHT_DIR")
                       or os.path.join(data_dir, "trace_artifacts"))
    if args.dist_slot == 0 and s.fresh:
        # slot 0 bootstraps leadership for a BRAND-NEW cluster only
        # (fresh = no prior WAL); a restarted slot 0 must rejoin via
        # ordinary elections
        import numpy as np

        s._campaign(np.ones(g, bool))
    cors = parse_cors(args.cors) if args.cors else None
    lcurls = urls_from_flags(args, "listen_client_urls", "bind_addr",
                             explicit, client_tls.empty())
    for u in lcurls:
        host, port = _split_hostport(u)
        _serve_client(args, s, cors, host, port,
                      new_listener_context(client_tls))
        log.info("Listening for client requests on %s (dist slot "
                 "%d/%d, %d groups on %s)", u, args.dist_slot,
                 len(peers), g, device)

    _block_forever()
    return 0


def _start_dist_roles(args, explicit: set[str], peers: list[str],
                      data_dir: str, g: int) -> int:
    """Role-split dist mode (--dist-roles S): this host serves its
    slot as a supervised family of processes — a stateless ingest on
    the client port, an apply/watch worker on client port + m, and S
    serving shards each peering on peer port + m*s
    (server/roles.py).  Blocks until the supervisor is stopped."""
    from .server import roles

    if args.dist_roles < 1 or g % args.dist_roles:
        log.error("--dist-roles=%d must be >= 1 and divide "
                  "--cohosted-groups=%d", args.dist_roles, g)
        return 1
    client_tls = TLSInfo(args.cert_file, args.key_file, args.ca_file)
    peer_tls = TLSInfo(args.peer_cert_file, args.peer_key_file,
                       args.peer_ca_file)
    if not client_tls.empty() or not peer_tls.empty():
        # the shared-memory handoff and derived-port fan-out are
        # loopback-only; the TLS story stays with the single-process
        # server
        log.error("--dist-roles does not support TLS")
        return 1
    lcurls = urls_from_flags(args, "listen_client_urls", "bind_addr",
                             explicit, True)
    _, client_port = _split_hostport(next(iter(lcurls)))
    # slot 0 bootstraps a brand-new cluster only (same rule as the
    # single-process path); "fresh" = no shard has a data dir yet
    fresh = not os.path.exists(os.path.join(data_dir, "shard0"))
    argv = ["--role", "supervise",
            "--data-dir", data_dir,
            "--slot", str(args.dist_slot),
            "--peers", ",".join(peers),
            "--client-port", str(client_port),
            "--shards", str(args.dist_roles),
            "--groups", str(g),
            "--cap", str(ROLE_SHARD_CAP),
            "--name", f"{args.name}-{args.dist_slot}",
            "--election-ticks", str(args.dist_election_ticks),
            "--lease-ticks", str(args.dist_lease_ticks),
            "--pipeline-depth", str(args.dist_pipeline_depth),
            "--coalesce-us", str(args.dist_coalesce_us),
            "--flight-dir",
            os.environ.get("ETCD_FLIGHT_DIR")
            or os.path.join(data_dir, "trace_artifacts")]
    if args.snapshot_count is not None:
        argv += ["--snap-count", str(args.snapshot_count)]
    if args.dist_slot == 0 and fresh:
        argv.append("--bootstrap")
    roles.main(argv)
    return 0


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
    try:
        mesh = _local_mesh(args.cohosted_mesh_devices,
                           args.cohosted_groups, device)
    except ValueError as e:
        log.error("--cohosted-mesh-devices: %s", e)
        return 1
    s = MultiGroupServer(
        data_dir, g=args.cohosted_groups, m=args.cohosted_members,
        name=args.name, snap_count=args.snapshot_count,
        storage_backend=args.storage_backend,
        client_urls=list(acurls), mesh=mesh, device=device)
    s.start()
    cors = parse_cors(args.cors) if args.cors else None
    lcurls = urls_from_flags(args, "listen_client_urls", "bind_addr",
                             explicit, client_tls.empty())
    for u in lcurls:
        host, port = _split_hostport(u)
        _serve_client(args, s, cors, host, port,
                      new_listener_context(client_tls))
        log.info("Listening for client requests on %s "
                 "(%d co-hosted groups x %d members on %s)",
                 u, args.cohosted_groups, args.cohosted_members, device)

    _block_forever()
    return 0


def start_etcd(args, cluster: Cluster, explicit: set[str],
               device) -> int:
    """Reference startEtcd (main.go:126-209): the classic single-group
    server, its restart's replay and snapshot hash on ``device``."""
    self_m = cluster.find_name(args.name)
    if self_m is None:
        log.error("etcd: no member with name=%r exists", args.name)
        return 1

    data_dir = args.data_dir
    if not data_dir:
        data_dir = f"{self_m.id}_etcd_data"
        log.info("main: no data-dir provided, using default data-dir "
                 "./%s", data_dir)
    os.makedirs(data_dir, mode=0o700, exist_ok=True)

    client_tls = TLSInfo(args.cert_file, args.key_file, args.ca_file)
    peer_tls = TLSInfo(args.peer_cert_file, args.peer_key_file,
                       args.peer_ca_file)

    acurls = urls_from_flags(args, "advertise_client_urls", "addr",
                             explicit, client_tls.empty())
    cfg = ServerConfig(
        name=args.name,
        client_urls=acurls,
        data_dir=data_dir,
        snap_count=args.snapshot_count,
        cluster=cluster,
        discovery_url=args.discovery,
        cluster_state=args.initial_cluster_state,
        storage_backend=args.storage_backend,
        peer_tls=peer_tls if not peer_tls.empty() else None,
    )
    s = new_server(cfg, device=device)
    s.start()

    cors = parse_cors(args.cors) if args.cors else None
    ph = make_peer_handler(s)

    lpurls = urls_from_flags(args, "listen_peer_urls", "peer_bind_addr",
                             explicit, peer_tls.empty())
    for u in lpurls:
        host, port = _split_hostport(u)
        serve(ph, host, port, new_listener_context(peer_tls))
        log.info("Listening for peers on %s", u)

    lcurls = urls_from_flags(args, "listen_client_urls", "bind_addr",
                             explicit, client_tls.empty())
    for u in lcurls:
        host, port = _split_hostport(u)
        _serve_client(args, s, cors, host, port,
                      new_listener_context(client_tls))
        log.info("Listening for client requests on %s (classic server "
                 "on %s)", u, device)

    _block_forever()
    return 0


def start_proxy(args, cluster: Cluster, explicit: set[str]) -> int:
    """Reference startProxy (main.go:212-249) + discovery bootstrap
    (main.go:253-275's glue): with --discovery set, the proxy's
    endpoint list comes from the discovery registry instead of the
    flag-built cluster."""
    client_tls = TLSInfo(args.cert_file, args.key_file, args.ca_file)
    peer_urls = cluster.peer_urls_all()
    if args.discovery:
        from .discovery.discovery import proxy_endpoints

        discovered = proxy_endpoints(args.discovery)
        if discovered:
            peer_urls = discovered
            log.info("proxy: discovered %d endpoints via %s",
                     len(discovered), args.discovery)
    addrs = [urllib.parse.urlsplit(u).netloc for u in peer_urls]
    scheme = "https" if not client_tls.empty() else "http"
    handler = NewProxyHandler(
        addrs, scheme=scheme,
        readonly=args.proxy == PROXY_VALUE_READONLY)

    lcurls = urls_from_flags(args, "listen_client_urls", "bind_addr",
                             explicit, client_tls.empty())
    for u in lcurls:
        host, port = _split_hostport(u)
        serve(handler, host, port, new_listener_context(client_tls))
        log.info("Listening for client requests on %s", u)

    _block_forever()
    return 0


def _serve_client(args, s, cors, host: str, port: int, ssl_context):
    """One client listener: the event-driven front door by default,
    the threaded server with --frontdoor=off (or under TLS, where the
    front door itself falls back)."""
    if args.frontdoor == "on":
        from .server.frontdoor import serve_frontdoor

        return serve_frontdoor(s, host, port, ssl_context=ssl_context,
                               cors=cors)
    return serve(make_client_handler(s, cors=cors), host, port,
                 ssl_context)


def _local_mesh(n: int, groups: int, device):
    """Build a local device mesh over the first ``n`` devices of
    ``device``'s kind, or None when ``n`` is 0.  Fails fast (ValueError,
    the reference's messages) on every flag misconfiguration: negative
    or oversized counts (``group_mesh`` raises) and a group count that
    does not split over the mesh, so the servers' own pre-disk guards
    never fire from the CLI path."""
    if not n:
        return None
    from .parallel.mesh import check_group_divisible, group_mesh, \
        local_devices

    mesh = group_mesh(n, devices=local_devices(device))
    check_group_divisible(mesh, groups)
    return mesh


def _split_hostport(u: str) -> tuple[str, int]:
    parsed = urllib.parse.urlsplit(u)
    return parsed.hostname or "", parsed.port or 0


def _block_forever() -> None:  # pragma: no cover
    threading.Event().wait()


if __name__ == "__main__":
    sys.exit(main())
