"""Heterogeneous cost study: the cheapest deployment that meets the SLO.

Prices candidate PD deployments that mix hardware generations per role
(H100 prefill + A800 decode and both homogeneous baselines, at several
pool sizes) over a shared 2:1-oversubscribed fabric, then answers the
question an operator actually asks: of the deployments that hold the
TTFT/TPOT SLO, which burns the fewest dollars per hour — and which
serves the most tokens per dollar?

    PYTHONPATH=src python examples_torch/heterogeneous_cost_study.py
"""
import json
import os

from repro_torch.api import SimSpec, run

SMOKE = bool(int(os.environ.get("SMOKE", "1")))
SLO_FLOOR = 0.99


def candidate(prefill_hw: str, decode_hw: str, n_prefill: int,
              n_decode: int) -> SimSpec:
    return SimSpec.from_dict({
        "name": f"{prefill_hw.split('-')[0]}x{n_prefill}"
                f"+{decode_hw.split('-')[0]}x{n_decode}",
        "model": {"name": "qwen2-7b", "smoke": True},
        "topology": {
            "preset": None,
            "clusters": [
                {"name": "prefill", "role": "prefill",
                 "n_replicas": n_prefill, "hardware": prefill_hw},
                {"name": "decode", "role": "decode",
                 "n_replicas": n_decode, "hardware": decode_hw},
            ],
            "links": [{"src": "prefill", "dst": "decode",
                       "bandwidth": 25.0e9, "latency": 10.0e-6}],
            "fabric": {"mode": "shared", "oversubscription": 2.0,
                       "latency_s": 5.0e-6},
        },
        "workload": {"n_requests": 300 if SMOKE else 3000, "rate": 400.0,
                     "arrival": "burst", "burst_size": 50,
                     "burst_period": 0.125, "prompt_mean": 1024,
                     "output_mean": 64, "seed": 3},
        "slo": {"ttft_s": 0.007, "tpot_s": 0.01},
        "seed": 3,
    })


def main():
    candidates = []
    for pre_hw, dec_hw in (("H100-SXM", "A800-SXM4-80G"),
                           ("H100-SXM", "H100-SXM"),
                           ("A800-SXM4-80G", "A800-SXM4-80G")):
        for n_pre, n_dec in ((1, 2), (2, 2), (2, 4)):
            candidates.append(candidate(pre_hw, dec_hw, n_pre, n_dec))

    rows = []
    for spec in candidates:
        rep = run(spec)
        s = rep.summary
        rows.append({
            "name": spec.name,
            "dollars_per_hour": s["dollars_per_hour"],
            "tok_per_s_per_dollar": s["tok_per_s_per_dollar"],
            "slo_attainment": s.get("slo_attainment"),
            "ttft_p99_s": s["ttft_p99_s"],
            "fabric_contention_delay_s": s.get(
                "fabric_contention_delay_s", 0.0),
            "meets_slo": (s.get("slo_attainment") or 0.0) >= SLO_FLOOR,
        })

    hdr = (f"{'deployment':22s} {'$/hr':>7s} {'tok/s/$':>9s} "
           f"{'slo':>6s} {'ttft_p99':>9s} {'contend_s':>10s} {'ok':>3s}")
    print(hdr + "\n" + "-" * len(hdr))
    for r in sorted(rows, key=lambda r: r["dollars_per_hour"]):
        print(f"{r['name']:22s} {r['dollars_per_hour']:7.2f} "
              f"{r['tok_per_s_per_dollar']:9.1f} "
              f"{r['slo_attainment'] or 0:6.3f} {r['ttft_p99_s']:9.4f} "
              f"{r['fabric_contention_delay_s']:10.4f} "
              f"{'y' if r['meets_slo'] else 'n':>3s}")

    feasible = [r for r in rows if r["meets_slo"]]
    assert feasible, "no candidate met the SLO; retune the study"
    cheapest = min(feasible, key=lambda r: r["dollars_per_hour"])
    best_value = max(feasible, key=lambda r: r["tok_per_s_per_dollar"])
    print(f"\ncheapest meeting SLO>={SLO_FLOOR}: {cheapest['name']} "
          f"at ${cheapest['dollars_per_hour']:.2f}/hr")
    print(f"best tok/s/$ meeting SLO:      {best_value['name']} "
          f"at {best_value['tok_per_s_per_dollar']:.1f} tok/s/$")

    os.makedirs("artifacts", exist_ok=True)
    with open("artifacts/heterogeneous_cost.json", "w") as f:
        json.dump({"rows": rows, "cheapest": cheapest["name"],
                   "best_value": best_value["name"]}, f, indent=2,
                  default=float)
    print("rows -> artifacts/heterogeneous_cost.json")


if __name__ == "__main__":
    main()
