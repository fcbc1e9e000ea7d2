"""Prometheus text exposition (format version 0.0.4) for the obs
registry (the port's copy of ``etcd_tpu/obs/exporter.py``).

Every catalog family is emitted — ``# HELP`` + ``# TYPE`` lines even
when no sample has landed yet — so a scrape always shows the full
metric inventory, and the ``GET /metrics`` contract (≥ 10 families
spanning wal/apply/election/peer-send/ack-RTT/devledger) holds from
the first request.

Escaping follows the exposition-format spec exactly: HELP text
escapes ``\\`` and newline; label values escape ``\\``, ``\"`` and
newline.  Histograms render cumulative ``_bucket`` series with
``le``, then ``_sum`` and ``_count``.
"""

from __future__ import annotations

import math

from .metrics import Registry, registry as default_registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labelstr(pairs: list[tuple[str, str]]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(str(v))}"'
                     for k, v in pairs)
    return "{" + inner + "}"


def render_prometheus(reg: Registry | None = None) -> bytes:
    reg = reg if reg is not None else default_registry
    lines: list[str] = []
    for fam in reg.families():
        d = fam.d
        lines.append(f"# HELP {d.name} {escape_help(d.help)}")
        lines.append(f"# TYPE {d.name} {d.kind}")
        for labelvalues, child in fam.children():
            base = list(zip(d.labels, labelvalues))
            if d.kind == "histogram":
                snap = child.snapshot()
                cum = 0
                for bound, n in zip(snap["bounds"],
                                    snap["buckets"]):
                    cum += n
                    lines.append(
                        f"{d.name}_bucket"
                        f"{_labelstr(base + [('le', _fmt(bound))])}"
                        f" {cum}")
                cum += snap["buckets"][-1]
                lines.append(
                    f"{d.name}_bucket"
                    f"{_labelstr(base + [('le', '+Inf')])} {cum}")
                lines.append(f"{d.name}_sum{_labelstr(base)} "
                             f"{_fmt(snap['sum'])}")
                lines.append(f"{d.name}_count{_labelstr(base)} "
                             f"{snap['count']}")
            else:
                lines.append(f"{d.name}{_labelstr(base)} "
                             f"{_fmt(child.get())}")
    return ("\n".join(lines) + "\n").encode()


def render_prometheus_snapshot(snap: dict) -> bytes:
    """Exposition over a snapshot-shaped dict ({family: {kind,
    help, samples}}) instead of a live Registry — the supervisor's
    merged cross-role form, where samples carry arbitrary
    label dicts (the injected ``role`` key included) rather than a
    family's declared label tuple.  Same 0.0.4 conformance as
    :func:`render_prometheus`: HELP/TYPE once per family, escaped
    label values, cumulative histogram buckets."""
    lines: list[str] = []
    for name in sorted(snap):
        fam = snap[name]
        kind = fam.get("kind", "untyped")
        lines.append(f"# HELP {name} "
                     f"{escape_help(fam.get('help', ''))}")
        lines.append(f"# TYPE {name} {kind}")
        for s in fam.get("samples", ()):
            base = sorted(s.get("labels", {}).items())
            if kind == "histogram":
                cum = 0
                for bound, n in zip(s["bounds"], s["buckets"]):
                    cum += n
                    lines.append(
                        f"{name}_bucket"
                        f"{_labelstr(base + [('le', _fmt(bound))])}"
                        f" {cum}")
                cum += s["buckets"][-1]
                lines.append(
                    f"{name}_bucket"
                    f"{_labelstr(base + [('le', '+Inf')])} {cum}")
                lines.append(f"{name}_sum{_labelstr(base)} "
                             f"{_fmt(s['sum'])}")
                lines.append(f"{name}_count{_labelstr(base)} "
                             f"{s['count']}")
            else:
                lines.append(f"{name}{_labelstr(base)} "
                             f"{_fmt(s.get('value', 0.0))}")
    return ("\n".join(lines) + "\n").encode()


__all__ = ["CONTENT_TYPE", "escape_help", "escape_label_value",
           "render_prometheus", "render_prometheus_snapshot"]
