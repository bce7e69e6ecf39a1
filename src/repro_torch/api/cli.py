"""``python -m repro_torch``: the command-line front door of the port.

    python -m repro_torch run spec.json
    python -m repro_torch sweep spec.json \
        --axis topology.tp=1,2,4 --axis workload.rate=5,10 --jobs 8
    python -m repro_torch calibrate --model mixtral-8x7b \
        --hardware H100-SXM --oracle kernels
    python -m repro_torch trace spec.json -o artifacts
    python -m repro_torch list

Reports land under ``artifacts/`` (JSON per run, JSONL per sweep),
self-describing: each carries its full spec, spec hash, and provenance.
Every subcommand runs on the card unless ``--device cpu`` is passed;
nothing steps down to the CPU on its own (``run`` and ``sweep`` read the
device only for ``opmodel.backend: jit``; ``trace`` as ``run``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.api.run import Report, run
from repro_torch.api.spec import SimSpec, SpecError
from repro_torch.api.sweep import pareto, sweep

SUMMARY_KEYS = (
    "n_completed", "duration_s", "throughput_tok_s",
    "throughput_tok_s_per_device", "ttft_p50_s", "ttft_p99_s",
    "tpot_p50_s", "tpot_p99_s", "e2e_p50_s", "e2e_p99_s",
    "queue_p50_s", "queue_p99_s", "goodput_tok_s", "slo_attainment",
    "bubble_time_s", "overlap_efficiency",
    # fleet control plane
    "fleet_instances_built", "fleet_instances_active_end",
    "scale_up_events", "scale_down_events", "rebalance_events",
    "routing_imbalance", "provisioned_gpu_seconds", "idle_gpu_seconds",
    "prefix_hit_token_frac", "tenant_slo_attainment_min",
    # $ accounting + shared-fabric contention
    "dollars_per_hour", "provisioned_dollars", "idle_dollars",
    "tok_per_s_per_dollar",
    "fabric_transfers", "fabric_exposed_comm_s",
    "fabric_contention_delay_s",
)


def _parse_value(tok: str) -> Any:
    try:
        return json.loads(tok)
    except (json.JSONDecodeError, ValueError):
        return tok


def _parse_values(text: str) -> List[Any]:
    """Parse an axis value list: JSON array semantics first (handles
    objects containing commas), else comma-split scalars."""
    try:
        v = json.loads(f"[{text}]")
        if isinstance(v, list):
            return v
    except (json.JSONDecodeError, ValueError):
        pass
    return [_parse_value(t) for t in text.split(",")]


def _split_kv(item: str, flag: str) -> tuple:
    if "=" not in item:
        raise SpecError(f"{flag} expects PATH=VALUE, got {item!r}")
    k, v = item.split("=", 1)
    return k.strip(), v


def _load_spec(path: str, sets: Sequence[str]) -> SimSpec:
    spec = SimSpec.load(path)
    updates = {}
    for item in sets or ():
        k, v = _split_kv(item, "--set")
        updates[k] = _parse_value(v)
    if updates:
        spec = spec.with_(**updates)
    return spec


def _print_summary(rep: Report, file=sys.stdout) -> None:
    label = rep.name or rep.spec_hash
    print(f"# {label}  (devices={rep.n_devices}, events={rep.sim_events}, "
          f"wall={rep.wall_clock_s:.2f}s)", file=file)
    for k in SUMMARY_KEYS:
        if rep.summary.get(k) is not None:   # empty-sample stats are None
            print(f"  {k:30s} {rep.summary[k]:14.6g}", file=file)
    if not rep.all_complete:
        print(f"  WARNING: incomplete — conservation: {rep.conservation}",
              file=file)


def _out_base(spec: SimSpec, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    label = spec.name or f"spec-{spec.spec_hash()}"
    return os.path.join(out_dir, label)


# -------------------------------------------------------------- commands --
def _cmd_run(args: argparse.Namespace) -> int:
    spec = _load_spec(args.spec, args.set)
    rep = run(spec, device=args.device)
    path = _out_base(spec, args.out) + ".report.json"
    rep.save(path)
    _print_summary(rep)
    print(f"report -> {path}")
    return 0 if rep.all_complete or args.until_ok else 1


def _cmd_trace(args: argparse.Namespace) -> int:
    from repro_torch.obs import (
        run_traced, write_chrome_trace, write_spans_jsonl, write_summary,
        render_summary,
    )
    spec = _load_spec(args.spec, args.set)
    # force observability on (keeping any obs options the spec sets)
    from dataclasses import asdict
    obs = asdict(spec.obs) if spec.obs is not None else {}
    obs["enabled"] = True
    if args.ep_spans:
        obs["ep_spans"] = True
    spec = spec.with_(obs=obs)
    rep, tel = run_traced(spec, device=args.device)
    if args.base:
        # a bare name lands inside --out; a path is taken literally
        base = (args.base if os.path.isabs(args.base)
                or os.sep in args.base
                else os.path.join(args.out, args.base))
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    else:
        base = _out_base(spec, args.out)
    top_n = args.top or (spec.obs.top_n if spec.obs else 5)
    outs = {
        "chrome": base + ".trace.json",
        "jsonl": base + ".spans.jsonl",
        "summary": base + ".summary.txt",
    }
    write_chrome_trace(tel, outs["chrome"])
    write_spans_jsonl(tel, outs["jsonl"])
    write_summary(tel, outs["summary"], top_n)
    rep.save(base + ".report.json")
    print(render_summary(tel, top_n))
    for kind, path in outs.items():
        print(f"{kind:8s} -> {path}")
    print(f"report   -> {base}.report.json")
    print("open the chrome trace at https://ui.perfetto.dev "
          "(or chrome://tracing)")
    return 0 if rep.all_complete or args.until_ok else 1


def _cmd_sweep(args: argparse.Namespace) -> int:
    spec = _load_spec(args.spec, args.set)
    axes: Dict[str, List[Any]] = {}
    for item in args.axis or ():
        k, v = _split_kv(item, "--axis")
        axes[k] = _parse_values(v)
    if not axes and not args.seeds:
        raise SpecError("sweep needs at least one --axis PATH=V1,V2,... "
                        "(or --seeds)")
    seeds = ([int(s) for s in args.seeds.split(",")]
             if args.seeds else None)
    jsonl = args.jsonl or (_out_base(spec, args.out) + ".sweep.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)      # streaming appends; start fresh per sweep

    def progress(done: int, total: int, rep: Report) -> None:
        tag = json.dumps(rep.point) if rep.point else rep.spec_hash
        thr = rep.summary.get("throughput_tok_s_per_device")
        tpot = rep.summary.get("tpot_p50_s")
        thr = float("nan") if thr is None else thr
        tpot = float("nan") if tpot is None else tpot * 1e3
        print(f"[{done}/{total}] {tag}  tok/s/dev={thr:.1f}  "
              f"tpot_p50={tpot:.2f}ms", flush=True)

    reports = sweep(spec, axes, mode="zip" if args.zip else "grid",
                    jobs=args.jobs, seeds=seeds, jsonl=jsonl,
                    progress=progress, device=args.device)
    front = pareto(reports)
    if front:
        print("\nPareto frontier (throughput x interactivity):")
        for r in front:
            print(f"  * {json.dumps(r.point) if r.point else r.spec_hash}")
    print(f"\n{len(reports)} reports -> {jsonl}")
    return 0


def _cmd_calibrate(args: argparse.Namespace) -> int:
    from repro_torch.calib import (
        CalibrationError, append_fidelity, calibrate, entry_from_result,
    )
    try:
        result = calibrate(
            model=args.model, hardware=args.hardware, oracle=args.oracle,
            smoke=args.smoke, n_train=args.train_samples,
            n_eval=args.eval_samples, seed=args.seed,
            max_len=args.max_len, max_batch=args.max_batch,
            out_root=args.out, device=args.device)
    except (CalibrationError, KeyError) as e:
        print(f"calibrate error: {e}", file=sys.stderr)
        return 2
    print(f"calibrated {result.model} on {result.hardware} "
          f"(oracle={result.oracle}, n_train={result.n_train}, "
          f"n_eval={result.n_eval}, wall={result.wall_s:.1f}s)")
    for op, fams in result.fidelity.items():
        print(f"  {op}:")
        for fam in ("fitted", "analytical", "vidur_proxy"):
            s = fams[fam]
            print(f"    {fam:12s} mape={s['mape']:8.3%}  "
                  f"p50={s['p50']:8.3%}  p99={s['p99']:8.3%}")
    for op, path in result.artifact_paths.items():
        print(f"  artifact -> {path}")
    entry = entry_from_result(result, args.label)
    if args.entry_out:
        with open(args.entry_out, "w") as f:
            json.dump(entry, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"  fidelity entry -> {args.entry_out}")
    if args.fidelity:
        append_fidelity(args.fidelity, entry)
        print(f"  fidelity trajectory -> {args.fidelity}")
    return 0


def _cmd_list(args: argparse.Namespace) -> int:
    from repro_torch.calib import ORACLES, discover_artifacts
    from repro_torch.configs import REGISTRY
    from repro_torch.core.hardware import HARDWARE
    from repro_torch.core.opmodels import OPMODELS
    from repro_torch.core.pipeline import PIPELINES
    from repro_torch.core.policies.batching import BATCHING
    from repro_torch.core.policies.memory import MEMORY
    from repro_torch.core.policies.scheduling import SCHEDULERS
    from repro_torch.core.routing import ROUTERS
    from repro_torch.fleet.router import FLEET_ROUTERS
    from repro_torch.api.spec import ARRIVALS, PRESETS
    from repro_torch.core.fabric import COLLECTIVES, FABRIC_MODES
    from repro_torch.workload.generator import RATE_CURVES
    arts = [
        f"{a['hardware']}/{a['operator']} (model={a['model']} "
        f"oracle={a['oracle']}"
        + (f" mape={a['mape']:.2%}" if a.get("mape") is not None else "")
        + ")"
        for a in discover_artifacts()]
    hw_rows = []
    for n in sorted(HARDWARE):
        dph = HARDWARE[n].dollars_per_hour
        hw_rows.append(f"{n} (${dph:.2f}/GPU-hr)" if dph > 0
                       else f"{n} (unpriced)")
    sections = {
        "models": sorted(REGISTRY),
        "hardware": hw_rows,
        "fabric modes": [f"{m} (collectives: {', '.join(COLLECTIVES)})"
                         if m == "shared" else m for m in FABRIC_MODES],
        "topology presets": list(PRESETS) + ["(or inline clusters/links)"],
        "arrival processes": list(ARRIVALS),
        "rate curves": list(RATE_CURVES),
        "routers": sorted(ROUTERS),
        "fleet routers": sorted(FLEET_ROUTERS),
        "batching policies": sorted(BATCHING),
        "queue policies": sorted(SCHEDULERS),
        "memory managers": sorted(MEMORY),
        "operator models": sorted(OPMODELS),
        "oracle backends": sorted(ORACLES) + ["auto"],
        "calibration artifacts (artifacts/calib_torch)": arts or ["(none found)"],
        "pipeline presets": sorted(PIPELINES),
    }
    want = getattr(args, "what", None)
    for title, names in sections.items():
        if want and want not in title:
            continue
        print(f"{title}:")
        for n in names:
            print(f"  {n}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Frontier simulator, PyTorch/CUDA port")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run one spec, write a JSON report")
    p.add_argument("spec", help="path to a SimSpec .yaml/.json file")
    p.add_argument("-o", "--out", default="artifacts",
                   help="output directory (default: artifacts/)")
    p.add_argument("--set", action="append", metavar="PATH=VALUE",
                   help="override a spec field, e.g. --set workload.rate=20")
    p.add_argument("--until-ok", action="store_true",
                   help="exit 0 even if the run left incomplete requests "
                        "(time-bounded runs)")
    p.add_argument("--device", default="cuda",
                   help="where opmodel.backend jit evaluates: cuda "
                        "(default) or cpu")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser(
        "trace",
        help="run one spec with observability on; export a Perfetto-"
             "loadable chrome trace, a JSONL span log, and a text summary")
    p.add_argument("spec", help="path to a SimSpec .yaml/.json file")
    p.add_argument("-o", "--out", default="artifacts",
                   help="output directory (default: artifacts/)")
    p.add_argument("--base", default=None,
                   help="explicit output basename (writes BASE.trace.json, "
                        "BASE.spans.jsonl, BASE.summary.txt, "
                        "BASE.report.json); a bare name lands inside "
                        "--out, a path is taken literally")
    p.add_argument("--top", type=int, default=None,
                   help="top-N slowest requests in the summary "
                        "(default: spec obs.top_n, else 5)")
    p.add_argument("--ep-spans", action="store_true",
                   help="also record per-EP-rank dispatch/compute/combine "
                        "spans (AF MoE clusters; traces the inner event "
                        "graph on cache-miss steps)")
    p.add_argument("--set", action="append", metavar="PATH=VALUE")
    p.add_argument("--until-ok", action="store_true",
                   help="exit 0 even if the run left incomplete requests")
    p.add_argument("--device", default="cuda",
                   help="where opmodel.backend jit evaluates: cuda "
                        "(default) or cpu")
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser("sweep",
                       help="expand axes over a base spec, stream JSONL")
    p.add_argument("spec")
    p.add_argument("--axis", action="append", metavar="PATH=V1,V2,...",
                   help="sweep axis (repeatable); values parse as JSON "
                        "when possible")
    p.add_argument("--zip", action="store_true",
                   help="pair axes positionally instead of the cartesian "
                        "product")
    p.add_argument("--jobs", type=int, default=1,
                   help="parallel worker processes (default 1 = serial)")
    p.add_argument("--seeds", default=None, metavar="S1,S2,...",
                   help="replicate every point with these seeds")
    p.add_argument("-o", "--out", default="artifacts")
    p.add_argument("--jsonl", default=None,
                   help="explicit JSONL output path")
    p.add_argument("--set", action="append", metavar="PATH=VALUE")
    p.add_argument("--device", default="cuda",
                   help="where opmodel.backend jit evaluates: cuda "
                        "(default; workers are spawned) or cpu")
    p.set_defaults(fn=_cmd_sweep)

    p = sub.add_parser(
        "calibrate",
        help="fit operator models against an oracle, write artifacts + "
             "FIDELITY_torch.json")
    p.add_argument("--model", default="qwen2-7b",
                   help="model config whose operator geometry to fit "
                        "(default qwen2-7b)")
    p.add_argument("--smoke", action="store_true",
                   help="fit the reduced smoke geometry")
    p.add_argument("--hardware", default="A800-SXM4-80G",
                   help="hardware preset to calibrate for")
    p.add_argument("--oracle", default="auto",
                   choices=("kernelsim", "kernels", "hlo", "auto"),
                   help="ground-truth backend: kernelsim | kernels | hlo | "
                        "auto (auto is kernels; it never steps down)")
    p.add_argument("--device", default="cuda",
                   help="where the kernels oracle runs: cuda (default) "
                        "or cpu (times the plain versions); for hlo, the "
                        "fake tensors' device")
    p.add_argument("--train-samples", type=int, default=600,
                   help="training grid size (default 600)")
    p.add_argument("--eval-samples", type=int, default=150,
                   help="held-out eval grid size (default 150)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-len", type=int, default=None,
                   help="cap sampled sequence lengths (default: oracle "
                        "limit)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="cap sampled batch sizes (default: oracle limit)")
    p.add_argument("-o", "--out", default=os.path.join("artifacts", "calib_torch"),
                   help="artifact root (default artifacts/calib_torch/, the "
                        "port's own: the reference reads artifacts/calib); "
                        "artifacts land under <out>/<hardware>/")
    p.add_argument("--fidelity", default="FIDELITY_torch.json",
                   help="fidelity trajectory to append to "
                        "(default FIDELITY_torch.json)")
    p.add_argument("--no-fidelity", dest="fidelity", action="store_const",
                   const=None, help="do not touch the trajectory file")
    p.add_argument("--label", default="dev",
                   help="trajectory entry label (entries dedupe by label)")
    p.add_argument("--entry-out", default=None,
                   help="also write the fresh fidelity entry to this path")
    p.set_defaults(fn=_cmd_calibrate)

    p = sub.add_parser("list", help="show registries a spec can reference")
    p.add_argument("what", nargs="?", default=None,
                   help="filter sections by substring")
    p.set_defaults(fn=_cmd_list)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except SpecError as e:
        print(f"spec error: {e}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except BrokenPipeError:      # e.g. `python -m repro_torch list | head`
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
