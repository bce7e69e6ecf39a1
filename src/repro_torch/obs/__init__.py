"""Observability: request spans, sim-time counters, trace export.

Everything here is off-by-default.  A simulation run pays nothing unless
a :class:`~repro_torch.obs.telemetry.Telemetry` recorder is attached — every
instrumentation site in the core guards on ``telemetry is not None``, so
``obs: off`` runs are byte-identical to pre-observability builds.

Enable declaratively::

    spec = SimSpec(..., obs=ObsSpec())
    rep, tel = run_traced(spec)
    write_chrome_trace(tel, "out.trace.json")   # load in Perfetto
    write_spans_jsonl(tel, "out.spans.jsonl")
    print(render_summary(tel))

or from the CLI: ``python -m repro_torch trace spec.json --out artifacts/t``.
"""
from repro_torch.obs.attribution import ATTRIBUTION_KEYS, attribution_for
from repro_torch.obs.counters import CounterBoard
from repro_torch.obs.sinks import (
    SINKS,
    SPANS_SCHEMA_VERSION,
    TraceSink,
    engine_events_to_chrome,
    read_spans_jsonl,
    render_summary,
    write_chrome_trace,
    write_spans_jsonl,
    write_summary,
)
from repro_torch.obs.spans import SPAN_CATEGORY, Span
from repro_torch.obs.telemetry import RequestRecord, Telemetry, attach_telemetry

__all__ = [
    "ATTRIBUTION_KEYS", "CounterBoard", "RequestRecord", "SINKS",
    "SPANS_SCHEMA_VERSION", "SPAN_CATEGORY", "Span", "Telemetry",
    "TraceSink", "attach_telemetry", "attribution_for",
    "engine_events_to_chrome", "read_spans_jsonl", "render_summary",
    "run_traced", "write_chrome_trace", "write_spans_jsonl",
    "write_summary",
]


def run_traced(spec, device="cuda"):
    """Run ``spec`` with telemetry attached; return ``(report, tel)``.

    Forces observability on (a default ``ObsSpec`` is injected when the
    spec carries none; other obs options are preserved), so this is the
    one-call entry point for trace studies and the ``repro_torch trace``
    CLI verb.  ``device`` is handed to :func:`repro_torch.api.run.run`.
    """
    from dataclasses import asdict

    from repro_torch.obs.telemetry import Telemetry

    if spec.obs is None or not spec.obs.enabled:
        obs = asdict(spec.obs) if spec.obs is not None else {}
        obs["enabled"] = True
        spec = spec.with_(obs=obs)
    tel = Telemetry.from_spec(spec.obs)
    if spec.fleet is not None:
        from repro_torch.fleet.report import run_fleet
        rep = run_fleet(spec, telemetry=tel, device=device)
    else:
        from repro_torch.api.run import run
        rep = run(spec, telemetry=tel, device=device)
    return rep, tel
