"""Trace study: record a run, export it, read it back, explain the tail.

Runs the traced PD spec (``examples_torch/specs/trace.json``), fans the
recorded telemetry out to all three sinks (Perfetto chrome trace, spans
JSONL, text summary), then — deliberately — reads its *own* JSONL back
with :func:`read_spans_jsonl` and reconstructs the critical path of the
five slowest requests span by span.  That round trip is the point: the
artifact on disk, not the in-memory recorder, is what post-hoc analysis
tooling gets to see.

    PYTHONPATH=src python examples_torch/trace_study.py

Open ``artifacts/trace-study-pd.trace.json`` at https://ui.perfetto.dev
to see the same requests on the instance/replica timeline.
"""
import os

from repro_torch.api import SimSpec
from repro_torch.obs import (ATTRIBUTION_KEYS, read_spans_jsonl, render_summary,
                       run_traced, write_chrome_trace, write_spans_jsonl,
                       write_summary)

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = os.path.join(HERE, "specs", "trace.json")
OUT = os.path.join(HERE, "..", "artifacts")


def record(out_dir: str) -> str:
    """Run the traced spec, write all three artifacts, return the jsonl."""
    spec = SimSpec.load(SPEC)
    rep, tel = run_traced(spec)
    assert rep.all_complete, rep.conservation

    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, spec.name or "trace")
    write_chrome_trace(tel, base + ".trace.json")
    write_spans_jsonl(tel, base + ".spans.jsonl")
    write_summary(tel, base + ".summary.txt")

    print(render_summary(tel))
    fracs = {k: rep.summary[f"attribution_{k[:-2]}_frac"]
             for k in ATTRIBUTION_KEYS}
    assert abs(sum(fracs.values()) - 1.0) < 1e-6, fracs
    print(f"\nartifacts under {os.path.relpath(out_dir)}/ "
          f"(load the .trace.json in Perfetto)")
    return base + ".spans.jsonl"


def critical_paths(jsonl_path: str, top_n: int = 5) -> None:
    """Reconstruct the slowest requests' lifecycles from the file alone."""
    data = read_spans_jsonl(jsonl_path)
    print(f"\n== read back {data['header']['n_spans']} spans / "
          f"{data['header']['n_requests']} requests from "
          f"{os.path.basename(jsonl_path)} ==")

    by_rid = {}
    for s in data["spans"]:
        by_rid.setdefault(s.rid, []).append(s)
    slowest = sorted(data["requests"], key=lambda r: r["e2e"],
                     reverse=True)[:top_n]

    for rec in slowest:
        a = rec["attribution"]
        print(f"\nrid={rec['rid']} e2e={rec['e2e'] * 1e3:.1f}ms  "
              + "  ".join(f"{k[:-2]}={a[k] * 1e3:.1f}ms"
                          for k in ATTRIBUTION_KEYS if a[k] > 0))
        for s in sorted(by_rid.get(rec["rid"], []),
                        key=lambda s: (s.start, s.end)):
            extra = ""
            if s.kind == "prefill_chunk":
                extra = (f" chunk={s.meta.get('chunk')}"
                         f"/{s.meta.get('total')}")
            elif s.kind == "decode":
                extra = f" epochs={s.meta.get('epochs')}"
            elif s.kind == "kv_transfer":
                extra = (f" bytes={s.meta.get('bytes')}"
                         f" exposed={s.meta.get('exposed_s')}")
            print(f"  [{s.start * 1e3:9.2f} -> {s.end * 1e3:9.2f} ms] "
                  f"{s.kind:<15s} {s.replica or '-':<10s}"
                  f" ({s.category or 'detail'}){extra}")
    print("\nReading: the tail requests queue behind the burst, then pay "
          "chunked prefill and the PD KV hop before decode; attribution "
          "says how much of each e2e was queue vs compute vs comm.")


def main():
    jsonl = record(OUT)
    critical_paths(jsonl, top_n=5)


if __name__ == "__main__":
    main()
