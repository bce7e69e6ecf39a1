"""Calibration study: close the sim-to-real loop end to end.

1. Calibrate the refined operator models against an oracle (kernelsim by
   default — swap in the real CUDA kernels with --oracle kernels on the
   card) and print the fitted / analytical / vidur-proxy error
   table on the held-out heterogeneous grid.  The fit keeps calibrate's
   default hardware, A800-SXM4-80G, so --oracle kernels labels the card's
   times as an A800's.
2. Run the SAME serving workload twice — analytical roofline vs fitted
   models — and show how much the operator model moves the end-to-end
   numbers the simulator reports.

    PYTHONPATH=src python examples_torch/calibration_study.py [--smoke]
        [--oracle kernels] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.api import ModelRef, SimSpec, TopologySpec, WorkloadSpec, run
from repro_torch.calib import calibrate

MODEL = "qwen2-7b"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced geometry + grid (CI)")
    ap.add_argument("--oracle", default="kernelsim")
    ap.add_argument("--out", default="artifacts/calib_torch")
    ap.add_argument("--device", default="cuda",
                    help="where the oracle and the runs go; nothing steps down")
    args = ap.parse_args(argv)

    n_train, n_eval = (160, 60) if args.smoke else (600, 150)
    print(f"== calibrating {MODEL} (oracle={args.oracle}, "
          f"n_train={n_train}) ==")
    res = calibrate(model=MODEL, oracle=args.oracle, smoke=args.smoke,
                    n_train=n_train, n_eval=n_eval, out_root=args.out,
                    device=args.device)
    for op, fams in res.fidelity.items():
        print(f"  {op}: held-out relative error")
        for fam in ("fitted", "analytical", "vidur_proxy"):
            s = fams[fam]
            print(f"    {fam:12s} mape={s['mape']:8.3%}  "
                  f"p50={s['p50']:8.3%}  p99={s['p99']:8.3%}")

    wl = WorkloadSpec(n_requests=60 if args.smoke else 200, rate=10.0,
                      prompt_mean=256 if args.smoke else 1024,
                      output_mean=32 if args.smoke else 128)
    base = SimSpec(name="calib-study",
                   model=ModelRef(MODEL, smoke=args.smoke),
                   topology=TopologySpec(preset="colocated", n_replicas=2,
                                         tp=1),
                   workload=wl, seed=0)
    analytical = run(base, device=args.device)
    fitted = run(base.with_(**{"opmodel.name": "refined",
                               "opmodel.calibration": args.out}),
                 device=args.device)
    print("\n== same workload, two operator models ==")
    print(f"{'':24s}{'analytical':>14s}{'fitted':>14s}")
    for key in ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                "throughput_tok_s"):
        a, f = analytical.summary.get(key), fitted.summary.get(key)
        if a is not None and f is not None:
            print(f"  {key:22s}{a:14.6g}{f:14.6g}")
    drift = abs(fitted.summary["ttft_p50_s"]
                - analytical.summary["ttft_p50_s"])
    print(f"\nfitted-vs-analytical ttft_p50 drift: {drift * 1e3:.2f} ms "
          f"(the accuracy the analytical roofline leaves on the table)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
