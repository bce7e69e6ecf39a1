"""The sweep that finds a mix's knee, the highest rate the engine sustains,
once, when a cell is defined.  Not run by the benchmark's own runs.

    python3 perfbench/sweep.py --config yi-9b --traffic azure-conv.r4.0 \
        --rates 0.8,1.2,1.6 --seconds 30 --seed 5 [--out FILE]

One process: the weights and the engine once a configuration, then the
mix's open loop at each rate in turn, every request served to its end.  One
JSON line a rate: what was offered and served, the tails, and whether the
queue grew: the mean time to first token of the last third of the arrivals
over that of the first third.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True, help="comma-separated mixes")
    ap.add_argument("--rates", required=True, help="comma-separated, requests a second")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import perfbench.run  # noqa: F401  (the run's cache directories)
    import numpy as np
    import torch
    from perfbench import harness, traffic
    from perfbench.spec import Cell, load_config, load_traffic, model_shapes
    from perfbench.stats import pct
    from perfbench.weights import make_tree

    dev = torch.device("cuda")
    cfg = load_config(args.config)
    m = model_shapes(cfg)
    params = make_tree(m, args.seed, getattr(torch, cfg["dtype"]), dev)
    for name in args.traffic.split(","):
        mix = dict(load_traffic(name), judge="tails")
        cell = Cell(name=f"{args.config}.{name}", config=cfg, traffic=mix, limits={},
                    chips=1, end_to_end=[], per_layer=[])
        engine = harness.build_engine(cell, args.seed, dev, params=params)
        for rate in (float(r) for r in args.rates.split(",")):
            mix["rate"] = rate
            reqs = traffic.requests(mix, args.seed, args.seconds, m["V"])
            w = harness.window(engine, mix, reqs, args.seconds)
            done = [r for r in w.requests if r.ok]
            ttft = [(r.stamps[0] - r.submitted) * 1e3 for r in done]
            third = max(1, len(ttft) // 3)
            dec = [s for s in w.steps if s["kind"] == "decode"]
            line = {"config": args.config, "traffic": name, "rate": rate,
                    "requests": len(w.requests), "failed": len(w.requests) - len(done),
                    "window_s": w.seconds,
                    "out_tok_s": sum(len(r.tokens) for r in done) / w.seconds,
                    "ttft_p50_ms": pct(ttft, 50), "ttft_p95_ms": pct(ttft, 95),
                    "tpot_p95_ms": harness.end_to_end(w)["tpot_p95_ms"],
                    "queue_growth": (float(np.mean(ttft[-third:]) / np.mean(ttft[:third]))
                                     if ttft else None),
                    "decode_step_ms": 1e3 * sum(s["dur"] for s in dec) / max(1, len(dec)),
                    "occupancy": (sum(s["batch"] for s in dec) / max(1, len(dec))
                                  / int(mix["slots"])),
                    "memory_peak_bytes": torch.cuda.max_memory_allocated(dev),
                    "elapsed_s": time.perf_counter() - T0}
            print(json.dumps(line), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
        del engine
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
