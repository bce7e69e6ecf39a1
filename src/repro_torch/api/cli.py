"""``python -m repro_torch``: the command-line front door of the port.

    python -m repro_torch calibrate --model mixtral-8x7b --hardware H100-SXM \
        --oracle kernels

Only ``calibrate`` is registered so far.  It runs on the card unless
``--device cpu`` is passed; nothing steps down to the CPU on its own.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


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


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Frontier simulator, PyTorch/CUDA port")
    sub = ap.add_subparsers(dest="cmd", required=True)

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
                   choices=("kernelsim", "kernels", "auto"),
                   help="ground-truth backend: kernelsim | kernels | auto "
                        "(auto is kernels; it never steps down)")
    p.add_argument("--device", default="cuda",
                   help="where the kernels oracle runs: cuda (default) "
                        "or cpu (times the plain versions)")
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
    p.add_argument("-o", "--out", default=os.path.join("artifacts", "calib"),
                   help="artifact root (default artifacts/calib/); "
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

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except BrokenPipeError:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
