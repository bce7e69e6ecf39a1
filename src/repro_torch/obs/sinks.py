"""Trace sinks: chrome (Perfetto), jsonl, and text summary backends.

``TraceSink`` is a tiny protocol — ``write(tel, path)`` — so studies and
the CLI can fan one recorded run out to several formats.  The chrome
sink emits Chrome trace-event JSON loadable in Perfetto / ``chrome://
tracing``: instances (or clusters, for single-instance runs) map to
*processes*, replicas and EP ranks map to *threads*, counters become
counter tracks, and all timestamps are non-negative microseconds sorted
monotonically.

:func:`engine_events_to_chrome` is the repaired conversion for raw
engine-event rings (the old ``EventTrace.to_chrome_trace`` emitted
negative ``ts`` whenever an event's duration started before t=0 and
only honoured ``dur`` on BATCH_DONE); ``core/trace.py`` now delegates
here.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Protocol, Tuple

from repro_torch.obs.spans import Span
from repro_torch.obs.telemetry import Telemetry

SPANS_SCHEMA_VERSION = 1


class TraceSink(Protocol):
    def write(self, tel: Telemetry, path: str) -> None: ...


# ---- identity -> pid/tid mapping ------------------------------------------

def _span_scope(tel: Telemetry, s: Span) -> Tuple[str, str]:
    """(process label, thread label) for one span."""
    cluster, instance = tel.replica_info(s.replica)
    pid = instance or cluster or s.meta.get("instance") or "sim"
    rep = s.replica
    if instance and rep.startswith(instance + "/"):
        rep = rep[len(instance) + 1:]    # pid already names the instance
    if s.kind in ("ep_rank", "ep_dispatch"):
        tid = f"{rep}:ep{s.meta.get('rank', '?')}"
    elif rep:
        tid = rep
    else:
        tid = "requests"
    return pid, tid


def _counter_scope(tel: Telemetry, name: str) -> str:
    replica, instance = tel.counters.scope(name)
    if instance:
        return instance
    if replica:
        cluster, inst = tel.replica_info(replica)
        return inst or cluster or "sim"
    return "sim"


def chrome_trace_events(tel: Telemetry) -> List[dict]:
    """Trace-event list: metadata first, then ts-sorted spans/counters."""
    pid_ids: Dict[str, int] = {}
    tid_ids: Dict[Tuple[str, str], int] = {}
    body: List[dict] = []

    def pid_of(label: str) -> int:
        if label not in pid_ids:
            pid_ids[label] = len(pid_ids) + 1
        return pid_ids[label]

    def tid_of(pid_label: str, tid_label: str) -> int:
        key = (pid_label, tid_label)
        if key not in tid_ids:
            tid_ids[key] = sum(1 for p, _ in tid_ids if p == pid_label) + 1
        return tid_ids[key]

    # deterministic numbering: register every identity sorted first
    scopes = sorted({_span_scope(tel, s) for s in tel.spans}
                    | {(_counter_scope(tel, n), "") for n in
                       tel.counters.names()})
    for pid_label, tid_label in scopes:
        pid_of(pid_label)
        if tid_label:
            tid_of(pid_label, tid_label)

    for s in tel.spans:
        pid_label, tid_label = _span_scope(tel, s)
        pid, tid = pid_of(pid_label), tid_of(pid_label, tid_label)
        ts = max(s.start, 0.0) * 1e6
        args = {"rid": s.rid, **s.meta}
        if s.end > s.start:
            dur = (min(s.dur, s.end) if s.start < 0.0 else s.dur) * 1e6
            body.append({"name": s.kind, "ph": "X", "pid": pid, "tid": tid,
                         "ts": ts, "dur": dur, "cat": s.category or "detail",
                         "args": args})
        else:
            body.append({"name": s.kind, "ph": "i", "pid": pid, "tid": tid,
                         "ts": ts, "s": "t", "args": args})
    for name in tel.counters.names():
        pid = pid_of(_counter_scope(tel, name))
        for t, v in tel.counters.series(name):
            body.append({"name": name, "ph": "C", "pid": pid, "tid": 0,
                         "ts": max(t, 0.0) * 1e6, "args": {"value": v}})
    body.sort(key=lambda e: (e["ts"], e["pid"], e.get("tid", 0), e["name"]))

    meta: List[dict] = []
    for label, pid in sorted(pid_ids.items(), key=lambda kv: kv[1]):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": label}})
    for (pid_label, tid_label), tid in sorted(tid_ids.items(),
                                              key=lambda kv: kv[1]):
        if tid_label:
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": pid_ids[pid_label], "tid": tid,
                         "args": {"name": tid_label}})
    return meta + body


def write_chrome_trace(tel: Telemetry, path: str) -> None:
    with open(path, "w") as f:
        json.dump({"traceEvents": chrome_trace_events(tel),
                   "displayTimeUnit": "ms"}, f)


# ---- jsonl spans -----------------------------------------------------------

def write_spans_jsonl(tel: Telemetry, path: str) -> None:
    """One JSON object per line: a header, every span (with resolved
    identity), then one record per finished request with attribution."""
    with open(path, "w") as f:
        f.write(json.dumps({"type": "header",
                            "version": SPANS_SCHEMA_VERSION,
                            "n_spans": len(tel.spans),
                            "dropped_spans": tel.dropped_spans,
                            "n_requests": len(tel.records)}) + "\n")
        for s in tel.spans:
            d = s.to_dict()
            cluster, instance = tel.replica_info(s.replica)
            d["type"] = "span"
            d["cluster"] = cluster
            d["instance"] = instance
            d["category"] = s.category
            f.write(json.dumps(d) + "\n")
        for rec in tel.records:
            d = rec.to_dict()
            d["type"] = "request"
            f.write(json.dumps(d) + "\n")


def read_spans_jsonl(path: str) -> dict:
    """Round-trip reader: {'header': ..., 'spans': [Span], 'requests':
    [dict]} — what ``examples/trace_study.py`` uses to reconstruct
    critical paths."""
    header = None
    spans: List[Span] = []
    requests: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            t = d.pop("type", "span")
            if t == "header":
                header = d
            elif t == "span":
                spans.append(Span.from_dict(d))
            else:
                requests.append(d)
    return {"header": header or {}, "spans": spans, "requests": requests}


# ---- text summary ----------------------------------------------------------

def render_summary(tel: Telemetry, top_n: int = 5) -> str:
    """Top-N slowest requests with attribution, plus run-level fractions."""
    lines: List[str] = []
    frac = tel.attribution_fractions()
    lines.append(f"requests={len(tel.records)} spans={len(tel.spans)} "
                 f"(dropped={tel.dropped_spans}) "
                 f"counter_series={len(tel.counters)}")
    lines.append("attribution: " + "  ".join(
        f"{k.replace('_frac', '')}={v:.1%}" for k, v in frac.items()))
    lines.append(f"top {top_n} slowest requests:")
    for rec in tel.slowest(top_n):
        a = rec.attribution
        where = f" inst={rec.instance}" if rec.instance else ""
        lines.append(
            f"  rid={rec.rid} e2e={rec.e2e * 1e3:.1f}ms "
            f"ttft={'n/a' if rec.ttft is None else f'{rec.ttft * 1e3:.1f}ms'}"
            f"{where} | queue={a['queue_s'] * 1e3:.1f} "
            f"compute={a['compute_s'] * 1e3:.1f} "
            f"comm={a['comm_s'] * 1e3:.1f} "
            f"preempt={a['preempt_s'] * 1e3:.1f} "
            f"stall={a['stall_s'] * 1e3:.1f} (ms)")
    return "\n".join(lines)


def write_summary(tel: Telemetry, path: str, top_n: int = 5) -> None:
    with open(path, "w") as f:
        f.write(render_summary(tel, top_n) + "\n")


SINKS = {"chrome": write_chrome_trace, "jsonl": write_spans_jsonl,
         "summary": write_summary}


# ---- repaired raw engine-event conversion ---------------------------------

def engine_events_to_chrome(events: Iterable[tuple]) -> List[dict]:
    """Convert an ``EventTrace`` ring — (t, kind, data) tuples — to
    trace events.  Any event whose data carries a numeric ``dur`` (not
    just BATCH_DONE) becomes a duration event; starts are clamped to
    t >= 0 with the duration truncated to match, so ``ts`` is never
    negative."""
    out: List[dict] = []
    for t, kind, data in events:
        dur = data.get("dur") if isinstance(data, dict) else None
        if isinstance(dur, (int, float)) and dur > 0:
            start = t - dur
            if start < 0.0:
                dur += start        # truncate the pre-t=0 portion
                start = 0.0
            name = kind
            if kind == "batch_done":
                name = (f"batch p{data.get('n_prefill', 0)}"
                        f"/d{data.get('n_decode', 0)}")
            out.append({"name": name, "ph": "X", "pid": 0,
                        "tid": data.get("replica", "?"),
                        "ts": start * 1e6, "dur": dur * 1e6})
        else:
            out.append({"name": kind, "ph": "i", "pid": 0, "tid": "events",
                        "ts": max(t, 0.0) * 1e6, "s": "g"})
    out.sort(key=lambda e: e["ts"])
    return out
