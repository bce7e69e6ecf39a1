"""The reference's observability cases (``tests/test_obs.py``) through
the port, on the CPU: obs-off runs are untouched, obs-on runs do not
perturb any simulated metric, per-request attribution sums to e2e
(property-tested), the chrome export is Perfetto-loadable with a pinned
pid/tid map, the JSONL span log round-trips, and a fleet run with obs
enabled produces ONE merged trace with instances as processes; then the
same traced specs through both packages, whose reports, spans and traces
must be equal."""
import json
import os
from pathlib import Path

import pytest

import repro.api as R
import repro.obs as RO
from repro_torch.api import SimSpec, run as _run
from repro_torch.obs import (
    CounterBoard, SPAN_CATEGORY, Span, Telemetry, attribution_for,
    engine_events_to_chrome, read_spans_jsonl, render_summary,
    run_traced as _run_traced, write_chrome_trace, write_spans_jsonl,
)
from repro_torch.obs.sinks import chrome_trace_events

GOLDEN_DIR = Path(__file__).parent / "golden"


def run(spec, **kwargs):
    """The port's ``run`` on the CPU, as every case here calls it."""
    return _run(spec, device="cpu", **kwargs)


def run_traced(spec):
    return _run_traced(spec, device="cpu")

# burst arrivals so queue_wait spans (and the "sim" request track) are
# guaranteed to exist in the pinned trace fixture
TINY_PD = {
    "name": "obs-tiny-pd",
    "model": {"name": "qwen2-7b", "smoke": True},
    "topology": {"preset": "pd", "n_prefill": 1, "n_decode": 1},
    "workload": {"n_requests": 12, "arrival": "burst", "burst_size": 12,
                 "burst_period": 1.0, "prompt_mean": 4096,
                 "output_mean": 16, "seed": 7},
    "seed": 7,
}


def _tiny_pd():
    return SimSpec.from_dict(TINY_PD)


# ---------------------------------------------------------------- gating --
@pytest.mark.parametrize("preset", ["colocated", "pd_disagg", "memory_pd"])
def test_obs_on_does_not_perturb_summary(preset):
    """Tracing is read-only: every simulated metric is bit-identical
    with and without the recorder attached (the golden suite separately
    pins obs-off == pre-observability)."""
    from test_golden import SPECS
    rep_off = run(SimSpec.from_dict(SPECS[preset]))
    rep_on, tel = run_traced(SimSpec.from_dict(SPECS[preset]))
    common = {k: v for k, v in rep_on.summary.items()
              if not k.startswith(("attribution_", "obs_"))}
    assert common == rep_off.summary
    assert len(tel.records) == rep_off.summary["n_completed"]


def test_obs_off_spec_serializes_like_pre_obs_spec():
    spec = _tiny_pd()
    assert "obs" not in spec.to_dict()
    on = spec.with_(obs={"enabled": True})
    assert on.spec_hash() != spec.spec_hash()
    # dropping the section restores the exact pre-obs hash
    d = on.to_dict()
    d.pop("obs")
    assert SimSpec.from_dict(d).spec_hash() == spec.spec_hash()


def test_summary_obs_keys_only_when_enabled():
    rep_off = run(_tiny_pd())
    assert not any(k.startswith(("attribution_", "obs_"))
                   for k in rep_off.summary)
    rep_on, _ = run_traced(_tiny_pd())
    for k in ("attribution_queue_frac", "attribution_compute_frac",
              "attribution_comm_frac", "attribution_preempt_frac",
              "attribution_stall_frac", "obs_spans", "obs_dropped_spans",
              "obs_counter_series"):
        assert k in rep_on.summary
    fracs = [v for k, v in rep_on.summary.items()
             if k.startswith("attribution_")]
    assert abs(sum(fracs) - 1.0) < 1e-9


# ----------------------------------------------------------- attribution --
def test_attribution_components_sum_to_e2e_for_real_run():
    _, tel = run_traced(_tiny_pd())
    assert tel.records
    for rec in tel.records:
        assert abs(sum(rec.attribution.values()) - rec.e2e) < 1e-6
        assert all(v >= -1e-12 for v in rec.attribution.values())


def test_attribution_priority_and_stall():
    # compute over comm over queue on overlap; remainder is stall
    spans = [
        Span("queue_wait", 0, 0.0, 4.0),
        Span("kv_transfer", 0, 2.0, 6.0, "d0"),
        Span("prefill_chunk", 0, 3.0, 5.0, "d0"),
    ]
    a = attribution_for(spans, 0.0, 10.0)
    assert a["queue_s"] == pytest.approx(2.0)    # [0,2) unshadowed
    assert a["comm_s"] == pytest.approx(2.0)     # [2,3) + [5,6)
    assert a["compute_s"] == pytest.approx(2.0)  # [3,5)
    assert a["preempt_s"] == 0.0
    assert a["stall_s"] == pytest.approx(4.0)    # [6,10)
    assert sum(a.values()) == pytest.approx(10.0)


def test_attribution_clips_to_window():
    spans = [Span("prefill_chunk", 0, -5.0, 20.0, "d0")]
    a = attribution_for(spans, 1.0, 3.0)
    assert a["compute_s"] == pytest.approx(2.0)
    assert a["stall_s"] == 0.0


_KINDS = sorted(k for k, c in SPAN_CATEGORY.items() if c is not None)

try:                      # keep the rest of this module runnable without it
    from hypothesis import given, settings, strategies as st
    HAS_HYPOTHESIS = True
except ImportError:
    HAS_HYPOTHESIS = False

if HAS_HYPOTHESIS:
    _span_st = st.tuples(
        st.sampled_from(_KINDS),
        st.floats(min_value=-10.0, max_value=100.0, allow_nan=False,
                  allow_infinity=False),
        st.floats(min_value=0.0, max_value=50.0, allow_nan=False,
                  allow_infinity=False))

    @settings(max_examples=200, deadline=None)
    @given(st.lists(_span_st, max_size=25),
           st.floats(min_value=0.0, max_value=30.0, allow_nan=False,
                     allow_infinity=False),
           st.floats(min_value=0.0, max_value=120.0, allow_nan=False,
                     allow_infinity=False))
    def test_attribution_sums_to_e2e_property(span_data, arrival, dur):
        finish = arrival + dur
        spans = [Span(kind, 0, s, s + d, "w") for kind, s, d in span_data]
        a = attribution_for(spans, arrival, finish)
        assert abs(sum(a.values()) - (finish - arrival)) < 1e-6
        assert all(v >= 0.0 for v in a.values())
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_attribution_sums_to_e2e_property():
        pass


# -------------------------------------------------------------- recorder --
def test_decode_spans_coalesce():
    tel = Telemetry()
    for i in range(5):
        tel.compute_span("decode", 3, i * 0.1, (i + 1) * 0.1, "d0")
    assert len(tel.spans) == 1
    s = tel.spans[0]
    assert s.meta["epochs"] == 5
    assert s.start == 0.0 and s.end == pytest.approx(0.5)
    # a gap starts a fresh span
    tel.compute_span("decode", 3, 1.0, 1.1, "d0")
    assert len(tel.spans) == 2


def test_span_cap_counts_drops():
    tel = Telemetry(max_spans=3)
    for i in range(10):
        tel.span("prefill_chunk", i, 0.0, 1.0, replica="p0")
    assert len(tel.spans) == 3
    assert tel.dropped_spans == 7
    assert tel.summary_fields()["obs_dropped_spans"] == 7


def test_counterboard_bounded_and_peak_preserving():
    cb = CounterBoard(max_points=32)
    for i in range(100_000):
        cb.sample("x", float(i), 1.0 if i != 54_321 else 999.0)
    pts = cb.series("x")
    assert len(pts) <= 64          # 2 * max_points
    assert pts[0][0] == 0.0        # first timestamp survives
    assert max(v for _, v in pts) == 999.0   # the spike survives
    ts = [t for t, _ in pts]
    assert ts == sorted(ts)


# ----------------------------------------------------------------- sinks --
def test_chrome_trace_matches_golden_structure():
    """Pinned trace fixture on the tiny PD spec: pid/tid naming and the
    per-phase event counts must not drift silently."""
    _, tel = run_traced(_tiny_pd())
    evs = chrome_trace_events(tel)
    pid_map = {e["args"]["name"]: e["pid"] for e in evs
               if e["ph"] == "M" and e["name"] == "process_name"}
    tid_map = {f'{e["pid"]}:{e["tid"]}': e["args"]["name"] for e in evs
               if e["ph"] == "M" and e["name"] == "thread_name"}
    n_by_phase = {}
    for e in evs:
        n_by_phase[e["ph"]] = n_by_phase.get(e["ph"], 0) + 1
    payload = {"pid_map": pid_map, "tid_map": tid_map,
               "n_by_phase": n_by_phase}
    path = GOLDEN_DIR / "obs_trace_pd.json"
    if os.environ.get("REPRO_UPDATE_GOLDENS"):
        path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
        pytest.skip(f"golden updated: {path}")
    assert path.exists(), (f"missing golden fixture {path}; generate with "
                           f"REPRO_UPDATE_GOLDENS=1")
    assert json.loads(path.read_text()) == payload


def test_chrome_trace_valid_and_monotone(tmp_path):
    _, tel = run_traced(_tiny_pd())
    out = tmp_path / "t.trace.json"
    write_chrome_trace(tel, str(out))
    data = json.loads(out.read_text())     # strict JSON
    evs = data["traceEvents"]
    body = [e for e in evs if e["ph"] != "M"]
    assert body
    ts = [e["ts"] for e in body]
    assert ts == sorted(ts)
    assert all(t >= 0 for t in ts)
    assert all(e["dur"] >= 0 for e in body if e["ph"] == "X")
    # metadata precedes the body
    assert evs[0]["ph"] == "M"
    assert any(e["ph"] == "C" for e in body)           # counter tracks


def test_spans_jsonl_roundtrip(tmp_path):
    _, tel = run_traced(_tiny_pd())
    out = tmp_path / "t.spans.jsonl"
    write_spans_jsonl(tel, str(out))
    back = read_spans_jsonl(str(out))
    assert back["header"]["version"] == 1
    assert back["header"]["n_spans"] == len(tel.spans)
    assert len(back["spans"]) == len(tel.spans)
    for orig, rt in zip(tel.spans, back["spans"]):
        assert (rt.kind, rt.rid, rt.replica) == \
            (orig.kind, orig.rid, orig.replica)
        assert rt.start == orig.start and rt.end == orig.end
    assert len(back["requests"]) == len(tel.records)
    for req in back["requests"]:
        assert set(req["attribution"]) == {
            "queue_s", "compute_s", "comm_s", "preempt_s", "stall_s"}


def test_render_summary_lists_slowest():
    _, tel = run_traced(_tiny_pd())
    text = render_summary(tel, top_n=3)
    assert "top 3 slowest" in text
    worst = tel.slowest(1)[0]
    assert f"rid={worst.rid}" in text


# ------------------------------------------------- engine-trace shim fix --
def test_engine_events_to_chrome_clamps_negative_ts():
    evs = [
        (0.5, "batch_done", {"dur": 2.0, "replica": "w0", "n_prefill": 1,
                             "n_decode": 0}),
        (1.0, "kv_transfer_done", {"dur": 0.25}),   # dur honoured off-batch
        (0.1, "request_arrival", {"rid": 3}),
    ]
    out = engine_events_to_chrome(evs)
    assert all(e["ts"] >= 0 for e in out)
    ts = [e["ts"] for e in out]
    assert ts == sorted(ts)
    batch = next(e for e in out if e["name"].startswith("batch "))
    assert batch["ts"] == 0.0 and batch["dur"] == pytest.approx(0.5e6)
    kv = next(e for e in out if e["name"] == "kv_transfer_done")
    assert kv["ph"] == "X" and kv["dur"] == pytest.approx(0.25e6)


def test_event_trace_to_chrome_shim(tmp_path):
    from repro_torch.core.events import EV
    from repro_torch.core.trace import EventTrace
    tr = EventTrace(capacity=16)

    class _Ev:
        def __init__(self, time, kind, data):
            self.time, self.kind, self.data = time, kind, data

    tr(_Ev(0.2, EV.BATCH_DONE, {"dur": 1.0}))
    tr(_Ev(0.4, EV.TOKEN_GENERATED, {}))
    out = tmp_path / "shim.json"
    tr.to_chrome_trace(str(out))
    data = json.loads(out.read_text())
    assert all(e["ts"] >= 0 for e in data["traceEvents"])


# ----------------------------------------------------------------- fleet --
def test_fleet_trace_merges_instances_as_processes(tmp_path):
    from test_golden import SPECS
    spec = SimSpec.from_dict(SPECS["fleet_pd"])
    rep, tel = run_traced(spec)
    insts = {rec.instance for rec in tel.records}
    assert len(insts) > 1                  # work landed on several instances
    out = tmp_path / "fleet.trace.json"
    write_chrome_trace(tel, str(out))
    evs = json.loads(out.read_text())["traceEvents"]
    pnames = {e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "process_name"}
    assert insts <= pnames                 # one process per instance
    cnames = {e["name"] for e in evs if e["ph"] == "C"}
    assert "fleet_outstanding" in cnames
    assert "fleet_dollars_per_hour" in cnames
    # per-instance counters are namespaced: no two instances share a series
    for inst in insts:
        assert any(n.startswith(f"{inst}/") for n in cnames)
    body = [e for e in evs if e["ph"] != "M"]
    ts = [e["ts"] for e in body]
    assert ts == sorted(ts) and all(t >= 0 for t in ts)


def test_af_ep_spans_trace_ranks():
    spec = SimSpec.from_dict({
        "name": "obs-tiny-af",
        "model": {"name": "mixtral-8x7b", "smoke": True},
        "topology": {"preset": "af", "n_prefill": 1, "n_decode": 1,
                     "m": 2, "ffn_ep": 4},
        "workload": {"n_requests": 4, "rate": 20.0, "prompt_mean": 128,
                     "output_mean": 8, "seed": 5},
        "obs": {"enabled": True, "ep_spans": True},
        "seed": 5,
    })
    rep, tel = run_traced(spec)
    kinds = {s.kind for s in tel.spans}
    assert {"ep_dispatch", "ep_rank", "ep_combine"} <= kinds
    ranks = {s.meta["rank"] for s in tel.spans if s.kind == "ep_rank"}
    assert len(ranks) == 4                 # every EP rank traced
    # rank spans are absolute sim time within their batch window
    for s in tel.spans:
        if s.kind == "ep_rank":
            assert s.end >= s.start >= 0.0
    evs = chrome_trace_events(tel)
    tids = {e["args"]["name"] for e in evs
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert any(":ep" in t for t in tids)   # ranks as threads


# ------------------------------------------- the port against the reference --
def _traced_both(spec_dict):
    port, port_tel = run_traced(SimSpec.from_dict(spec_dict))
    ref, ref_tel = RO.run_traced(R.SimSpec.from_dict(spec_dict))
    return (port, port_tel), (ref, ref_tel)


@pytest.mark.parametrize("case", ["tiny_pd", "fleet_pd", "af_ep_spans"])
def test_traced_run_equals_the_reference(case, tmp_path):
    """The same spec traced by both packages: equal summaries (the
    attribution and obs keys included), equal span logs and equal chrome
    traces, byte for byte."""
    from test_golden import SPECS
    spec_dict = {"tiny_pd": TINY_PD, "fleet_pd": SPECS["fleet_pd"],
                 "af_ep_spans": dict(
                     TINY_PD, name="obs-tiny-af",
                     model={"name": "mixtral-8x7b", "smoke": True},
                     topology={"preset": "af", "n_prefill": 1,
                               "n_decode": 1, "m": 2, "ffn_ep": 4},
                     obs={"enabled": True, "ep_spans": True})}[case]
    (port, port_tel), (ref, ref_tel) = _traced_both(spec_dict)
    assert port.spec_hash == ref.spec_hash
    assert json.dumps(port.summary, sort_keys=True, default=float) == \
        json.dumps(ref.summary, sort_keys=True, default=float)
    for tel, write, name in ((port_tel, write_chrome_trace, "port"),
                             (ref_tel, RO.write_chrome_trace, "ref")):
        write(tel, str(tmp_path / f"{name}.trace.json"))
    for tel, write, name in ((port_tel, write_spans_jsonl, "port"),
                             (ref_tel, RO.write_spans_jsonl, "ref")):
        write(tel, str(tmp_path / f"{name}.spans.jsonl"))
    for ext in ("trace.json", "spans.jsonl"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"ref.{ext}").read_bytes()
    assert render_summary(port_tel) == RO.render_summary(ref_tel)
