"""End-to-end driver: REAL serving of a small model with batched requests,
then the simulator predicting the same system (paper Table-2 protocol).

    PYTHONPATH=src python examples_torch/serve_real_model.py [--device cpu]
"""
import argparse

import torch

from repro_torch.launch.serve import run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; nothing steps down")
    a = ap.parse_args(argv)
    out = run("qwen2-7b", batch=4, prompt_len=32, output_len=24,
              calibrate=False, device=a.device)
    where = (torch.cuda.get_device_name(a.device)
             if torch.device(a.device).type == "cuda" else "CPU")
    m, p = out["measured"], out["predicted"]
    print(f"real MiniEngine (PyTorch, {where}):")
    print(f"  throughput {m['throughput_tok_s']:8.1f} tok/s   "
          f"ttft {m['ttft_mean_s']*1e3:7.1f} ms   "
          f"tpot {m['tpot_mean_s']*1e3:6.1f} ms")
    print(f"Frontier simulation ({where}-calibrated hardware profile):")
    print(f"  throughput {p['throughput_tok_s']:8.1f} tok/s   "
          f"ttft {p['ttft_p50_s']*1e3:7.1f} ms   "
          f"tpot {p['tpot_p50_s']*1e3:6.1f} ms")
    err = abs(p["throughput_tok_s"] - m["throughput_tok_s"]) \
        / m["throughput_tok_s"]
    print(f"relative error: {err:.1%}")


if __name__ == "__main__":
    main()
