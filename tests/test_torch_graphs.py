"""Steps captured in CUDA graphs (``repro_torch.graphs``), the port's twin
of the reference's ``jax.jit``.

On the CPU: how launches are counted when a graph replays (recorded at
capture, added at each replay), and that the CPU runs the steps
uncaptured.  On the card (``gpu``-marked, skipped elsewhere): a graphed
``MiniEngine`` serves the eager engine's tokens and logits for a dense, an
MoE and both recurrent architectures, its replays count the WKV6 kernel's
launches as eager launches do, and a captured training step equals the
eager one step for step, to the bit, for a dense, an MoE and an rwkv6 model,
on one card and, for the dense and the MoE model, on a (1, 1) mesh over a
one-rank NCCL world (in a process of its own: this file run as a script).
Run the card's cases with ``python -m pytest -m gpu tests/test_torch_graphs.py``.

This file imports the port only, so it also runs where jax is not installed.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.graphs import Graphed
from repro_torch.kernels import _build, ops
from repro_torch.launch.train import run as train_run
from repro_torch.models import build_model, init_tree
from repro_torch.models.common import tree_leaves
from repro_torch.serving.engine import MiniEngine
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamW, AdamWConfig, StaticTrainStep

LENGTHS = (12, 20, 7, 16, 30)      # buckets of 16 and 32 tokens
CHUNKED = {"rwkv_impl": "chunked", "rwkv_chunk": 8}
SERVED = [("qwen2-7b", None), ("mixtral-8x7b", None), ("rwkv6-1.6b", CHUNKED),
          ("recurrentgemma-2b", None)]
SERVED_IDS = ["qwen2-7b", "mixtral-8x7b", "rwkv6-chunked", "recurrentgemma-2b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode, and "
                    "the WKV6 kernel needs nvcc")
    return "cuda"


class _Wrapper:
    launches = 0


# ------------------------------------------------------------------- CPU --
def test_capture_records_launches_and_replays_add_them():
    w = _Wrapper()
    with _build.recording() as tally:
        _build.count_launch(w)
        _build.count_launch(w)
    assert w.launches == 0 and tally == {w: 2}
    _build.count_launch(w)
    assert w.launches == 1
    _build.add_launches(tally)
    _build.add_launches(tally)
    assert w.launches == 5


def test_recordings_do_not_nest():
    with _build.recording():
        with pytest.raises(RuntimeError, match="already recording"):
            with _build.recording():
                pass
    w = _Wrapper()
    _build.count_launch(w)           # the failed inner one left nothing behind
    assert w.launches == 1


def test_a_graph_needs_a_warm_up_call():
    with pytest.raises(ValueError, match="warm-up"):
        Graphed(lambda: None, warmup=0)


@pytest.mark.parametrize("eager", [False, True])
def test_cpu_engine_runs_its_steps_uncaptured(eager):
    eng = MiniEngine(get_config("qwen2-7b", smoke=True), max_slots=2,
                     max_seq=64, device="cpu", eager=eager)
    assert not eng.graphed and not isinstance(eng._decode, Graphed)
    rng = np.random.default_rng(0)
    reqs = eng.submit([rng.integers(0, 512, n) for n in (12, 20)], 3)
    eng.run()
    assert [len(r.tokens) for r in reqs] == [3, 3]
    assert not any(isinstance(step, Graphed) for _, step in eng._prefills.values())


# ------------------------------------------------------------------ card --
def _serve_twice(eng, prompts, n_new):
    """A warm pass (which captures on the card), then a measured one; the
    tokens of both and the launches of the measured one."""
    reqs = eng.submit(prompts, n_new)
    eng.run()
    first = [r.tokens for r in reqs]
    ops.reset_launch_counts()
    reqs = eng.submit(prompts, n_new)
    eng.run()
    torch.cuda.synchronize()
    return first, [r.tokens for r in reqs], ops.launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("arch,options", SERVED, ids=SERVED_IDS)
def test_graphed_engine_serves_the_eager_tokens(cuda, arch, options):
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in LENGTHS]
    out = {}
    for eager in (False, True):
        eng = MiniEngine(cfg, max_slots=2, max_seq=64, seed=0, device=cuda,
                         dtype=torch.bfloat16, options=options, eager=eager)
        out[eager] = _serve_twice(eng, prompts, 6)[:2]
        if not eager:
            assert eng._decode.captured
            assert all(step.captured for _, step in eng._prefills.values())
    assert out[False] == out[True]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,options", SERVED, ids=SERVED_IDS)
def test_replayed_decode_logits_equal_eager_to_the_bit(cuda, arch, options):
    """Every decode step's logits, the capturing step's and the replays',
    equal the eager engine's bit for bit: the same kernels in the same
    order on the same inputs."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (16, 20, 12)]
    logits = {}
    for eager in (False, True):
        eng = MiniEngine(cfg, max_slots=2, max_seq=64, seed=0, device=cuda,
                         dtype=torch.bfloat16, options=options, eager=eager)
        seen, step = [], eng._decode

        def record(step=step, seen=seen):
            out = step()
            seen.append(out.clone())
            return out
        eng._decode = record
        eng.submit(prompts, 6)
        eng.run()
        logits[eager] = seen
    assert len(logits[False]) == len(logits[True]) >= 8
    for i, (got, want) in enumerate(zip(logits[False], logits[True])):
        diff = float((got.float() - want.float()).abs().max())
        assert torch.equal(got, want), f"decode step {i}: max |diff| {diff}"


@pytest.mark.gpu
def test_replays_count_the_eager_launches(cuda):
    """The WKV6 kernel runs inside the captured prefills: its launches,
    added at each replay, equal the eager engine's, one per layer and
    prefill."""
    cfg = get_config("rwkv6-1.6b", smoke=True)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (16, 32, 16)]
    counts = {}
    for eager in (False, True):
        eng = MiniEngine(cfg, max_slots=2, max_seq=64, seed=0, device=cuda,
                         dtype=torch.bfloat16, options=CHUNKED, eager=eager)
        counts[eager] = _serve_twice(eng, prompts, 4)[2]["wkv_chunked"]
    assert counts[False] == counts[True] == len(cfg.pattern) * len(prompts)


def _train(cfg, graph: bool, steps: int, remat: str):
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(cfg, remat=remat)
    params = init_tree(gen, model.pds(), torch.float32, "cuda")
    model.load_params(params)
    model.requires_grad_(True)
    opt = AdamW(AdamWConfig(lr=1e-3, zero1=False), model.ax)
    step = StaticTrainStep(model, opt, params, opt.init(params), graph=graph)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2, seed=3))
    losses = [float(step(data.batch(i))["loss"]) for i in range(steps)]
    return losses, step


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x7b", "rwkv6-1.6b"])
def test_captured_train_step_equals_the_eager_step(cuda, arch, remat):
    """Three eager warm-up steps, then the captured step replayed three
    times: every loss and every parameter equal the eager run's, to the
    bit, and the counter reads 6.  Dense, MoE (its dispatch and
    ``index_add_`` combine) and rwkv6 (its recurrence, on the scan path
    that training takes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, smoke=True), num_layers=2)
    want, eager = _train(cfg, False, 6, remat)
    got, graphed = _train(cfg, True, 6, remat)
    assert graphed._run.captured
    assert got == want
    assert int(graphed.opt_state["step"]) == 6
    for a, b in zip(tree_leaves(graphed.params), tree_leaves(eager.params)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_trainer_default_replays_and_eager_agrees(cuda):
    kw = dict(steps=6, seq_len=32, global_batch=2, layers=1, device=cuda,
              log_every=100)
    assert train_run("qwen3-8b", **kw)["losses"] == \
        train_run("qwen3-8b", eager=True, **kw)["losses"]


def _nccl_mesh_main(arch: str, out: str) -> None:
    """A one-rank NCCL world in this process: ``launch.train.run`` on a (1, 1)
    mesh, graphed and eager, at ``arch``'s smoke width with 2 layers; pickles
    whether each was captured, their losses, and whether every parameter
    and moment shard and the counter are equal."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{out}.store", rank=0,
                            world_size=1)
    try:
        kw = dict(steps=6, seq_len=32, global_batch=2, layers=2, device="cuda",
                  log_every=100, mesh_shape=(1, 1))
        graphed, eager = train_run(arch, **kw), train_run(arch, eager=True, **kw)
        same = [torch.equal(a.to_local(), b.to_local()) for a, b in zip(
            tree_leaves((graphed["params"], graphed["opt_state"])),
            tree_leaves((eager["params"], eager["opt_state"])))]
        res = {"backend": dist.get_backend(), "graphed": graphed["graphed"],
               "eager_graphed": eager["graphed"], "losses": graphed["losses"],
               "eager_losses": eager["losses"], "same": same,
               "step": int(graphed["opt_state"]["step"].to_local())}
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x7b"])
def test_mesh_train_step_replays_on_a_one_rank_nccl_world(cuda, arch, tmp_path):
    """The training step on a (1, 1) mesh of a one-rank NCCL world, its
    parameters DTensors and its MoE body under ``local_map``: captured after
    three eager steps and replayed three times, every loss, parameter,
    moment and the counter equal ``eager=True``'s to the bit."""
    out = tmp_path / "res.pkl"
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, __file__, arch, str(out)], env=env,
                          cwd=str(root), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out, "rb") as f:
        res = pickle.load(f)
    assert res["backend"] == "nccl"
    assert res["graphed"] and not res["eager_graphed"]
    assert res["losses"] == res["eager_losses"]
    assert all(res["same"]) and res["step"] == 6


if __name__ == "__main__":
    _nccl_mesh_main(*sys.argv[1:])
