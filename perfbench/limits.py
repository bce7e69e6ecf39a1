"""Readings the limits of ``correct`` are set from, for one cell, in one
process: for each seed, a run of the cell (set-up, a window of
``--seconds``, the check) and, on the same sampled requests, the control's
reading (the reference computed from float8 operands in the program's
place).  Not run by the benchmark's own runs.

    python3 perfbench/limits.py --workload <cell> --seeds 11,12,13 --seconds 1

Prints one JSON line per seed; ``--out`` also appends them to a file.
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--lower", default="fp8",
                    help="comma-separated precisions of the reference read beside "
                         "the program: fp8 (the control), bf16 (a witness); none")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import perfbench.run  # noqa: F401  (the run's cache directories)
    from perfbench import harness
    from perfbench.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    lower = [p for p in args.lower.split(",") if p and p != "none"]
    t0 = T0
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run(cell, seed=seed, seconds=args.seconds, trace=False, t0=t0,
                        lower=lower)
        line = {"workload": cell.name, "seed": seed, "correct": r["correct"],
                "attempted": r["attempted"], "failed": r["failed"],
                **{k: v["value"] for k, v in r["metrics"].items()},
                **r["readings"], "control_correct": r["control"],
                "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                "kind": r["device"]["kind"], "elapsed_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
