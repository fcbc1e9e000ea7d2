"""The port's single-group Raft (``etcd_tpu_torch.raft.{core,log,node}``)
against the JAX package's, on the CPU.

Two parts:

- every scenario of ``tests/test_raft_core.py`` (36), ``test_raft_log.py``
  (8) and ``test_raft_node.py`` (13), run against the port: each
  reference test module is executed with its ``etcd_tpu`` imports
  pointed at ``etcd_tpu_torch`` (:func:`port_module`), and its tests are
  collected here as ``test_core_*``, ``test_log_*`` and ``test_node_*``;
- lockstep walks: a 3-member group of ``Raft`` state machines per
  package, driven by the same seeded random walk of ``tick`` / ``step``
  (hup, proposals, deliveries, drops), compared after every call: every
  outbound message byte for byte, and the term, vote, commit, role,
  leader, log, progress and votes of every member; and three ``Node``s
  per package driven alike, every field of every ``Ready`` compared.

:func:`port_module` and :func:`export` are shared with the other
``test_torch_*`` files that reuse reference scenarios.
"""

from __future__ import annotations

import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import etcd_tpu.raft as jraft
import etcd_tpu.wire as jwire
import etcd_tpu_torch.raft as traft
import etcd_tpu_torch.wire as twire

TESTS = Path(__file__).resolve().parent


def port_module(ref: str, patches: dict | None = None):
    """The reference test module ``tests/<ref>.py`` with every
    ``etcd_tpu`` name pointed at ``etcd_tpu_torch`` (its imports of
    other test modules likewise, recursively), executed as the module
    ``_port_<ref>``.  ``patches`` (name -> function of the module)
    replaces module globals after the run, e.g. to pass ``device="cpu"``
    to an entry point that defaults to CUDA."""
    name = f"_port_{ref}"
    mod = sys.modules.get(name)
    if mod is None:
        path = TESTS / f"{ref}.py"
        src = re.sub(r"\betcd_tpu\b", "etcd_tpu_torch", path.read_text())
        for dep in re.findall(r"^from (test_\w+) import", src, flags=re.M):
            port_module(dep)
        src = re.sub(r"^from (test_\w+) import", r"from _port_\1 import",
                     src, flags=re.M)
        mod = types.ModuleType(name)
        mod.__file__ = str(path)
        sys.modules[name] = mod
        exec(compile(src, str(path), "exec"), mod.__dict__)
    for k, fn in (patches or {}).items():
        setattr(mod, k, fn(getattr(mod, k)))
    return mod


def export(mod, prefix: str, into: dict, skip: tuple = ()) -> int:
    """Bind ``mod``'s tests into the namespace ``into`` as
    ``test_<prefix>_<name>`` (their parametrize marks ride on the
    functions) and its fixtures under their own names; returns the
    number of test functions bound."""
    n = 0
    for k, v in list(vars(mod).items()):
        if hasattr(v, "_fixture_function_marker"):
            into.setdefault(k, v)
        elif k.startswith("test_") and callable(v) and k not in skip:
            into[f"test_{prefix}_{k[5:]}"] = v
            n += 1
    return n


# -- every reference scenario, on the port ------------------------------------

assert export(port_module("test_raft_core"), "core", globals()) == 36
assert export(port_module("test_raft_log"), "log", globals()) == 8
assert export(port_module("test_raft_node"), "node", globals()) == 13


# -- lockstep: the state machines ---------------------------------------------

IDS = (1, 2, 3)
ELECTION, HEARTBEAT = 10, 1


def _ents(es) -> list[bytes]:
    return [e.marshal() for e in es]


def _state(r) -> dict:
    lg = r.raft_log
    return {
        "term": r.term, "vote": r.vote, "commit": r.commit,
        "state": r.state, "lead": r.lead, "elapsed": r.elapsed,
        "pending_conf": r.pending_conf,
        "removed": dict(r.removed), "votes": dict(r.votes),
        "prs": {k: (p.match, p.next) for k, p in sorted(r.prs.items())},
        "ents": _ents(lg.ents), "offset": lg.offset,
        "committed": lg.committed, "applied": lg.applied,
        "unstable": lg.unstable, "snap": lg.snapshot.marshal(),
        "msgs": [m.marshal() for m in r.msgs],
    }


class _Group:
    """Three members of one package and their in-flight messages."""

    def __init__(self, raft, wire):
        self.wire = wire
        self.rs = {i: raft.Raft(i, list(IDS), ELECTION, HEARTBEAT)
                   for i in IDS}
        self.net: list = []

    def collect(self) -> None:
        for i in IDS:
            self.net.extend(self.rs[i].read_messages())

    def act(self, kind: str, who: int, k: int, data: bytes):
        w = self.wire
        r = self.rs[who]
        try:
            if kind == "tick":
                r.tick()
            elif kind == "hup":
                r.step(w.Message(type=w.MSG_HUP, from_=who, to=who))
            elif kind == "prop":
                r.step(w.Message(type=w.MSG_PROP, from_=who, to=who,
                                 entries=[w.Entry(data=data)]))
            elif kind in ("deliver", "drop") and self.net:
                m = self.net.pop(k % len(self.net))
                if kind == "deliver" and m.to in self.rs:
                    self.rs[m.to].step(m)
        except Exception as e:  # a panic must be the same on both sides
            self.collect()
            return type(e).__name__
        self.collect()
        return None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lockstep_random_walk(seed):
    rng = np.random.default_rng(seed)
    a, b = _Group(jraft, jwire), _Group(traft, twire)
    kinds = ("tick", "tick", "tick", "hup", "prop", "deliver", "deliver",
             "deliver", "deliver", "drop")
    commits = 0
    for step in range(3000):
        kind = kinds[int(rng.integers(len(kinds)))]
        who = int(rng.choice(IDS))
        k = int(rng.integers(1 << 30))
        data = rng.bytes(int(rng.integers(0, 64)))
        ea = a.act(kind, who, k, data)
        eb = b.act(kind, who, k, data)
        assert ea == eb, (step, kind, ea, eb)
        assert [m.marshal() for m in a.net] == [m.marshal() for m in b.net], \
            (step, kind)
        for i in IDS:
            assert _state(a.rs[i]) == _state(b.rs[i]), (step, kind, i)
        commits = max(commits, max(r.commit for r in a.rs.values()))
    # the walk went somewhere: leaders were elected and entries committed
    assert commits > 3


def test_message_bytes_equal_both_ways():
    rng = np.random.default_rng(7)
    for _ in range(200):
        ents = [dict(type=int(rng.integers(2)), term=int(rng.integers(1 << 40)),
                     index=int(rng.integers(1 << 40)),
                     data=rng.bytes(int(rng.integers(0, 40))))
                for _ in range(int(rng.integers(0, 4)))]
        snap = dict(data=rng.bytes(int(rng.integers(0, 16))),
                    nodes=[int(x) for x in rng.integers(1, 1 << 62, 3)],
                    index=int(rng.integers(1 << 40)),
                    term=int(rng.integers(1 << 40)),
                    removed_nodes=[int(rng.integers(1, 1 << 62))])
        kw = dict(type=int(rng.integers(9)), to=int(rng.integers(1 << 63)),
                  from_=int(rng.integers(1 << 63)),
                  term=int(rng.integers(1 << 40)),
                  log_term=int(rng.integers(1 << 40)),
                  index=int(rng.integers(1 << 40)),
                  commit=int(rng.integers(1 << 40)),
                  reject=bool(rng.integers(2)))
        jm = jwire.Message(entries=[jwire.Entry(**e) for e in ents],
                           snapshot=jwire.Snapshot(**snap), **kw)
        tm = twire.Message(entries=[twire.Entry(**e) for e in ents],
                           snapshot=twire.Snapshot(**snap), **kw)
        raw = jm.marshal()
        assert tm.marshal() == raw
        assert twire.Message.unmarshal(raw).marshal() == raw
        assert jwire.Message.unmarshal(tm.marshal()).marshal() == raw


def test_message_rejects_what_the_reference_rejects():
    from etcd_tpu.wire.proto import ProtoError as JErr
    from etcd_tpu_torch.wire.proto import ProtoError as TErr

    good = jwire.Message(type=3, to=2, from_=1, entries=[
        jwire.Entry(term=1, index=1, data=b"x")]).marshal()
    for bad in (b"\x00", b"\x0a\x00", good[:-1], b"\x3a\x05ab",
                good[:5] + b"\xff"):
        try:
            jwire.Message.unmarshal(bad)
            jok = True
        except JErr:
            jok = False
        try:
            twire.Message.unmarshal(bad)
            tok = True
        except TErr:
            tok = False
        assert jok == tok, bad


# -- lockstep: the node driver ------------------------------------------------


def _ready(rd) -> dict | None:
    if rd is None:
        return None
    ss = rd.soft_state
    return {
        "soft": None if ss is None else (ss.lead, ss.raft_state,
                                         list(ss.nodes), ss.should_stop),
        "hard": rd.hard_state.marshal(),
        "entries": _ents(rd.entries),
        "snapshot": rd.snapshot.marshal(),
        "committed": _ents(rd.committed_entries),
        "messages": [m.marshal() for m in rd.messages],
    }


class _Nodes:
    def __init__(self, raft, wire):
        peers = [raft.Peer(id=i, context=b"m%d" % i) for i in IDS]
        self.wire = wire
        self.ns = {i: raft.start_node(i, peers, ELECTION, HEARTBEAT)
                   for i in IDS}
        self.net: list = []

    def pull(self) -> list:
        out = []
        for i in IDS:
            rd = self.ns[i].ready(timeout=0)
            out.append(_ready(rd))
            if rd is None:
                continue
            self.net.extend(rd.messages)
            for e in rd.committed_entries:  # as the server's apply does
                if e.type == self.wire.ENTRY_CONF_CHANGE:
                    self.ns[i].apply_conf_change(
                        self.wire.ConfChange.unmarshal(e.data))
        return out

    def act(self, kind: str, who: int, k: int, data: bytes):
        n = self.ns[who]
        try:
            if kind == "tick":
                n.tick()
            elif kind == "campaign":
                n.campaign()
            elif kind == "prop":
                n.propose(data, timeout=0)
            elif kind in ("deliver", "drop") and self.net:
                m = self.net.pop(k % len(self.net))
                if kind == "deliver":
                    self.ns[m.to].step(m, timeout=0)
        except Exception as e:
            return type(e).__name__
        return None


@pytest.mark.parametrize("seed", [0, 1])
def test_lockstep_nodes_every_ready_field(seed):
    rng = np.random.default_rng(100 + seed)
    a, b = _Nodes(jraft, jwire), _Nodes(traft, twire)
    kinds = ("tick", "tick", "campaign", "prop", "prop", "deliver",
             "deliver", "deliver", "deliver", "drop")
    committed = 0
    assert a.pull() == b.pull()
    for step in range(1500):
        kind = kinds[int(rng.integers(len(kinds)))]
        who = int(rng.choice(IDS))
        k = int(rng.integers(1 << 30))
        data = rng.bytes(int(rng.integers(1, 48)))
        assert a.act(kind, who, k, data) == b.act(kind, who, k, data), step
        ra, rb = a.pull(), b.pull()
        assert ra == rb, (step, kind)
        committed += sum(len(r["committed"]) for r in ra if r)
    assert committed > 10
    for n in (*a.ns.values(), *b.ns.values()):
        n.stop()


def test_restart_node_equal_from_the_same_storage():
    rng = np.random.default_rng(5)
    ents = [(1, i + 1, rng.bytes(20)) for i in range(12)]
    snaps = {}
    for key, raft, wire in (("j", jraft, jwire), ("t", traft, twire)):
        snap = wire.Snapshot(data=b"state", nodes=[1, 2, 3], index=4,
                             term=1)
        st = wire.HardState(term=2, vote=1, commit=10)
        es = [wire.Entry(term=t, index=i, data=d)
              for t, i, d in ents if i > 4]
        n = raft.restart_node(1, ELECTION, HEARTBEAT, snap, st,
                              [wire.Entry(term=1, index=4)] + es)
        snaps[key] = (_ready(n.ready(timeout=0)), _state(n.r))
        n.stop()
    assert snaps["j"] == snaps["t"]
    with pytest.raises(ValueError):
        traft.restart_node(1, ELECTION, HEARTBEAT, None,
                           twire.HardState(term=1, commit=5), [])
