"""End-to-end training driver: the reference's ``repro/launch/train.py`` on
one device.

    python -m repro_torch.launch.train                       # on the card
    python -m repro_torch.launch.train --device cpu --steps 20

Runs AdamW steps (``training/optimizer.py``) of any ``--arch`` on the
deterministic synthetic stream (``training/data.py``), with step-atomic
checkpoints and ``--resume``.  ``run``'s arguments and defaults are the
reference's (the smoke geometry, f32); the port adds ``device`` (the card
unless the caller asks for the CPU), ``layers`` (keep that many full-width
layers, for the card's run of a real geometry) and, on the command line,
``--device``, ``--layers``, ``--smoke/--full``, ``--remat`` and ``--seed``.
Parameters come from ``init_tree`` on a ``torch.Generator`` seeded with
``seed`` on ``device``.

TF32 stays off for matmuls (torch's default; nothing here turns it on), so
an f32 run on the card computes what the same run computes on the CPU, to
rounding.

``mesh_shape`` trains on a mesh named ("data", "model")[:len(mesh_shape)]
over the process group the caller has initialised (one rank per mesh
position, every rank calling ``run`` alike): parameters placed by
``convert.shard_params``, ZeRO-1 moments, batches split over the batch axes,
as the reference's trainer does under ``jax.set_mesh``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import shard_params
from repro_torch.launch.lowering import place_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import AxisRules, build_model, init_tree
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamW, AdamWConfig, make_train_step


def small_config(base: ModelConfig, *, layers: int, d_model: int,
                 d_ff: int, vocab: int, heads: int) -> ModelConfig:
    return dataclasses.replace(
        base, num_layers=layers, d_model=d_model, d_ff=d_ff,
        vocab_size=vocab, num_heads=heads,
        num_kv_heads=min(base.num_kv_heads, heads), head_dim=d_model // heads)


def run(arch: str = "yi-9b", *, smoke: bool = True, steps: int = 50,
        seq_len: int = 128, global_batch: int = 8, lr: float = 1e-3,
        ckpt_dir: str = "", ckpt_every: int = 25, resume: bool = False,
        mesh_shape=None, log_every: int = 10, size: str = "smoke",
        dtype=torch.float32, seed: int = 0, remat: str = "none",
        device="cuda", layers=None):
    """Train; returns ``first_loss``, ``last_loss``, ``losses``, ``params``
    and ``opt_state`` as the reference does, and ``step_s``: each step's
    seconds, from the batch on the device to the loss on the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on the card by default and found no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    if size == "100m":
        cfg = small_config(get_config(arch), layers=8, d_model=512,
                           d_ff=2048, vocab=8192, heads=8)
    else:
        cfg = get_config(arch, smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)

    mesh = (make_mesh(mesh_shape, ("data", "model")[: len(mesh_shape)],
                      device.type) if mesh_shape else None)
    ax = AxisRules(mesh)
    model = build_model(cfg, ax, remat=remat)
    pds = model.pds()
    opt = AdamW(AdamWConfig(lr=lr, zero1=mesh is not None), ax)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = shard_params(init_tree(gen, pds, dtype, device), pds, ax)
    opt_state = opt.init(params, pds)
    start_step = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        on_mesh = {} if mesh is None else {
            "mesh": mesh, "shardings": ax.placement_tree(pds),
            "opt_shardings": ax.placement_tree(opt.state_pds(pds))}
        params, opt_state, start_step, _ = ckpt.restore(
            ckpt_dir, params_like=params, opt_like=opt_state, **on_mesh)
        print(f"resumed from step {start_step}")
    model.load_params(params)
    model.requires_grad_(True)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                  global_batch=global_batch, seed=seed))
    step_fn = make_train_step(model, opt)

    losses, step_s = [], []
    t0 = time.time()
    for step in range(start_step, start_step + steps):
        batch = data.batch(step)
        t_step = time.perf_counter()
        batch = place_batch(ax, {k: torch.from_numpy(v).to(device)
                                 for k, v in batch.items()})
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(_full(metrics["loss"]))
        step_s.append(time.perf_counter() - t_step)
        losses.append(loss)
        if step % log_every == 0 or step == start_step + steps - 1:
            dt = time.time() - t0
            tok_s = (step - start_step + 1) * global_batch * seq_len / dt
            print(f"step {step:5d} loss {loss:.4f} ({tok_s:,.0f} tok/s)")
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            path = ckpt.save(ckpt_dir, params=params, opt_state=opt_state,
                             step=step + 1,
                             extra={"arch": cfg.name, "loss": loss})
            print(f"checkpoint -> {path}")
    return {"first_loss": losses[0], "last_loss": losses[-1],
            "losses": losses, "params": params, "opt_state": opt_state,
            "step_s": step_s}


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--size", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep this many layers of the config")
    ap.add_argument("--smoke", dest="smoke", action="store_true", default=True,
                    help="the reduced geometry (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the config's full width")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    out = run(a.arch, smoke=a.smoke, steps=a.steps, seq_len=a.seq_len,
              global_batch=a.global_batch, lr=a.lr, ckpt_dir=a.ckpt_dir,
              ckpt_every=a.ckpt_every, resume=a.resume, size=a.size,
              log_every=a.log_every, seed=a.seed, remat=a.remat,
              device=a.device, layers=a.layers)
    print(f"loss: {out['first_loss']:.4f} -> {out['last_loss']:.4f}")


if __name__ == "__main__":
    main()
