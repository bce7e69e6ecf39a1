"""Multi-pod dry run: cost every (architecture x shape x mesh) cell at full
width without allocating anything.

Port of ``repro/launch/dryrun.py``.  The reference forces 512 host devices
(``XLA_FLAGS``) before anything else and lowers onto them.  Here each cell
runs in a ``fake`` process group of 256 (pod) or 512 (multipod) ranks on a
``FakeStore``, seen as rank 0, under ``make_production_mesh``: collectives
on it do nothing, and the step runs on fake tensors (``lowering.lower_step``),
so a 1T-parameter model costs no memory.  Each cell is ``build_step`` ->
``lower_step`` -> ``.compile()``, which counts the step's per-device flops,
bytes and collectives (``hlo_cost.Counter``).

    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh pod

Records go under ``artifacts/dryrun_torch/`` (``$REPRO_ARTIFACTS``), apart
from the reference's ``artifacts/dryrun/``; a failing cell is recorded and
makes ``main`` exit 1.  ``--device`` (default ``cuda``) is the fake tensors'
device: a fake CUDA tensor needs no card, and dispatch follows the card's
dtype rules.  A cell whose options route a layer to a hand-written kernel
(``--rwkv chunked``) reaches the kernel's op on fake CUDA tensors, and the
counter charges it as the kernel; its train cell fails, as it would on the
card, because no kernel has a backward.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch.lowering import build_step, lower_step
from repro_torch.launch.mesh import make_production_mesh

ARTIFACT_DIR = Path(os.environ.get("REPRO_ARTIFACTS", "artifacts")) / "dryrun_torch"


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` process group of ``world`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "one is already initialised")
    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             remat: str = "none", tag: str = "", options: dict = None,
             device: str = "cuda") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multipod" if multi_pod else "pod"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}

    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        t0 = time.time()
        bundle = build_step(cfg, mesh, shape, remat=remat, options=options)
        lowered = lower_step(bundle, mesh, device=device)
        t1 = time.time()
        compiled = lowered.compile()
        t2 = time.time()
        n_chips = mesh.size()

    mem = compiled.memory_analysis()
    costs = compiled.cost_analysis()
    mem_rec = {
        "argument_bytes": mem.argument_bytes,
        "output_bytes": mem.output_bytes,
        "temp_bytes": mem.temp_bytes,
        "alias_bytes": mem.alias_bytes,
        "generated_code_bytes": mem.generated_code_bytes,
    }
    print(f"[{arch} x {shape_name} x {mesh_name}] "
          f"compiled in {t2 - t1:.1f}s (lower {t1 - t0:.1f}s)")
    print("  memory_analysis:", mem_rec)
    print("  counted: flops=%.3e bytes=%.3e coll=%.3e" % (
        costs["flops"], costs["bytes"], costs["collective_bytes"]))

    counted = {k: float(v) for k, v in costs.items()}
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "tag": tag,
        "n_chips": n_chips,
        "step": bundle.name,
        "meta": bundle.meta,
        "lower_s": t1 - t0,
        "compile_s": t2 - t1,
        "memory_analysis": mem_rec,
        # no HLO: the counter's totals are both the raw and the corrected costs
        "cost_analysis_raw": counted,
        "hlo_corrected": dict(counted),
        "kernels": compiled.kernels,
        "package": "repro_torch",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Multi-pod dry run")
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--remat", default="none")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--attn", default="naive", choices=["naive", "blockwise"])
    ap.add_argument("--attn-block", type=int, default=1024)
    ap.add_argument("--rwkv", default="scan", choices=["scan", "chunked"])
    ap.add_argument("--rwkv-chunk", type=int, default=16)
    ap.add_argument("--moe", default="psum", choices=["psum", "a2a"])
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (no card is needed)")
    args = ap.parse_args(argv)
    options = {"attn_impl": args.attn, "attn_block": args.attn_block,
               "rwkv_impl": args.rwkv, "rwkv_chunk": args.rwkv_chunk,
               "moe_dispatch": args.moe}

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multipod" if mp else "pod"
                fname = outdir / f"{arch}__{shape}__{mesh_name}__{args.tag}.json"
                try:
                    rec = run_cell(arch, shape, mp, remat=args.remat,
                                   tag=args.tag, options=options,
                                   device=args.device)
                except Exception as e:  # a failing cell is a bug — record it
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "package": "repro_torch"}
                    failures.append((arch, shape, mesh_name))
                fname.write_text(json.dumps(rec, indent=2))
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete:", outdir)


if __name__ == "__main__":
    main()
