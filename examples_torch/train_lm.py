"""End-to-end training driver: ~100M-class LM for a few hundred steps with
checkpoints (restart-safe).  Runs on the card (--device cpu to taste);
the same code path is costed on the production meshes (launch/dryrun.py).

    PYTHONPATH=src python examples_torch/train_lm.py --steps 200
"""
import argparse

from repro_torch.launch.train import run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", default="100m", choices=["smoke", "100m"])
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_100m_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; nothing steps down")
    a = ap.parse_args()
    out = run("yi-9b", size=a.size, steps=a.steps, seq_len=256,
              global_batch=4, lr=3e-4, ckpt_dir=a.ckpt_dir, ckpt_every=50,
              resume=True, log_every=10, device=a.device)
    print(f"\nloss {out['first_loss']:.3f} -> {out['last_loss']:.3f} "
          f"over {a.steps} steps; checkpoints in {a.ckpt_dir}")


if __name__ == "__main__":
    main()
