"""The port's multi-device path against the reference, on worlds of CPU ranks.

The reference forces host devices and runs ``shard_map`` and GSPMD in one
process (``tests/test_distributed.py``).  The port's counterpart is a
``torch.distributed`` world: this file, run as a script, spawns one process
per rank on the ``gloo`` backend, each rank runs the cases of its world size
(``CASES``) and rank 0 pickles each case's result.  The worlds start once per
session (the ``worlds`` fixture, all at once) and every test reads its case's
result, holding it to the reference computed here in the test process from
the same inputs.  One more world is the card's kind: ranks as threads of one
process on the ``threaded`` backend (``chip_smoke.threaded_world``), here on
the CPU; and ``make_production_mesh`` is built on ``fake`` process groups of
256 and 512 ranks.

Cases: the reference's four (the sharded ZeRO-1 train step, the MoE
``shard_map`` bodies, elastic checkpoint resharding, ``build_step``), plus
TPFF, the vocab-sharded embedding and its fallback, ``launch.train.run`` on a
mesh with a resumed checkpoint, and sharded prefill and decode of every
architecture family against the same model unsharded; in the threaded
world, the gradients of three families on (2, 4) against unsharded.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT_S = 400
MOE_EP = dict(num_experts=8, top_k=2, expert_d_ff=32, capacity_factor_train=8.0)
MOE_TPFF = dict(num_experts=2, top_k=1, expert_d_ff=32, capacity_factor_train=8.0)
GRAD_ARCHS = ("yi-9b", "mixtral-8x7b", "rwkv6-1.6b")
FAMILIES = ["yi-9b", "gemma2-27b", "mixtral-8x7b", "kimi-k2-1t-a32b",
            "recurrentgemma-2b", "rwkv6-1.6b", "pixtral-12b",
            "seamless-m4t-large-v2"]
META_ARCHS = ["yi-9b", "mixtral-8x7b", "rwkv6-1.6b", "recurrentgemma-2b",
              "pixtral-12b", "seamless-m4t-large-v2"]
META_SHAPES = [("mini_train", 32, 4, "train"), ("mini_prefill", 64, 4, "prefill"),
               ("mini_dec", 64, 4, "decode")]


# ----------------------------------------------------------- the ranks' side --
def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes[-len(shape):], "cpu")


def _moe_cfg(moe):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    return dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                               moe=MoEConfig(**moe))


def _moe_run(inputs, key, moe, shape, dispatch, axes=("data", "model")):
    """The MoE layer on a mesh and on one device, forward and backward of a
    weighted sum of its output plus the load-balance loss."""
    from repro_torch.convert import shard_params
    from repro_torch.launch.lowering import place_batch
    from repro_torch.models.common import NO_RULES, AxisRules
    from repro_torch.models.moe import moe_apply, moe_pds
    cfg = _moe_cfg(moe)
    p_np, x_np, w_np = inputs[key]
    pds = moe_pds(cfg)

    def run(ax, p, x):
        for t in list(p.values()) + [x]:
            t.requires_grad_(True)
        y, aux = moe_apply(cfg, p, x, ax, train=True)
        w = torch.from_numpy(w_np)
        if ax.mesh is not None:
            w = ax.replicated(w).redistribute(ax.mesh, y.placements)
        ((y * w).sum() + aux["moe_lb_loss"]).backward()
        return {"y": _full(y).detach().numpy(),
                "drop": float(_full(aux["moe_drop_frac"])),
                "grads": {k: _full(v.grad).numpy() for k, v in p.items()},
                "gx": _full(x.grad).numpy()}

    one = run(NO_RULES, {k: torch.from_numpy(v) for k, v in p_np.items()},
              torch.from_numpy(x_np))
    ax = AxisRules(_mesh(shape, axes), {"moe_dispatch": dispatch})
    p = shard_params({k: torch.from_numpy(v) for k, v in p_np.items()}, pds, ax)
    x = place_batch(ax, {"x": torch.from_numpy(x_np)})["x"]
    return {"one": one, "mesh": run(ax, p, x)}


def case_moe_psum(rank, inputs):
    return _moe_run(inputs, "moe_ep", MOE_EP, (2, 4), "psum")


def case_moe_a2a(rank, inputs):
    return _moe_run(inputs, "moe_ep", MOE_EP, (2, 4), "a2a")


def case_moe_tpff(rank, inputs):
    return _moe_run(inputs, "moe_tpff", MOE_TPFF, (1, 4), "psum")


def case_moe_data_only(rank, inputs):
    return _moe_run(inputs, "moe_ep", MOE_EP, (4,), "psum", axes=("data",))


def _losses(cfg, params, batch, shape, *, remat="none", steps=3):
    from repro_torch.convert import shard_params
    from repro_torch.launch.lowering import place_batch
    from repro_torch.models import AxisRules, build_model
    from repro_torch.models.common import tree_map
    from repro_torch.training.optimizer import AdamW, AdamWConfig, make_train_step
    ax = AxisRules(_mesh(shape) if shape else None)
    model = build_model(cfg, ax, remat=remat)
    pds = model.pds()
    model.load_params(shard_params(tree_map(torch.clone, params), pds, ax))
    model.requires_grad_(True)
    p = model.param_tree()          # the tree the model holds, in its order
    opt = AdamW(AdamWConfig(lr=1e-3, zero1=True), ax)
    state = opt.init(p, pds)
    step = make_train_step(model, opt)
    batch = place_batch(ax, {k: torch.from_numpy(v) for k, v in batch.items()})
    out = []
    for _ in range(steps):
        p, state, m = step(p, state, batch)
        out.append(float(_full(m["loss"])))
    placed = [getattr(t, "placements", None) for t in state["m"]["layers"][0]["attn"].values()]
    return out, placed


def case_train_zero1(rank, inputs):
    """The reference test's qwen3-8b smoke step on (2, 4) with ZeRO-1, three
    steps; also under remat="full", and on one device."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-8b", smoke=True)
    params, batch = inputs["qwen3"]
    one, _ = _losses(cfg, params, batch, None)
    mesh, placed = _losses(cfg, params, batch, (2, 4))
    remat, _ = _losses(cfg, params, batch, (2, 4), remat="full", steps=2)
    return {"one": one, "mesh": mesh, "remat": remat,
            "moments_split_over_data": [pl[0].is_shard() for pl in placed]}


def case_reshard(rank, inputs):
    """The reference's elastic resharding: params and ZeRO-1 moments saved on
    (8,) "model", restored onto (2, 4)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.models import AxisRules, build_model, init_tree
    from repro_torch.models.common import shape_tree, tree_leaves, tree_map_with
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    cfg = get_config("yi-9b", smoke=True)
    pds = build_model(cfg).pds()
    params = init_tree(torch.Generator().manual_seed(0), pds, torch.float32, "cpu")
    ax_a = AxisRules(_mesh((8,), ("model",)))
    opt_a = AdamW(AdamWConfig(zero1=True), ax_a)
    p_a = shard_params(params, pds, ax_a)
    st_a = opt_a.init(p_a, pds)
    for t in tree_leaves(st_a["m"]):
        t.add_(1.5)                         # moments worth carrying
    d = tempfile.mkdtemp() if rank == 0 else None
    holder = [d]
    torch.distributed.broadcast_object_list(holder, src=0)
    d = holder[0]
    ckpt.save(d, params=p_a, opt_state=st_a, step=5)
    ax_b = AxisRules(_mesh((2, 4)))
    opt_b = AdamW(AdamWConfig(zero1=True), ax_b)
    placed = ax_b.placement_tree(pds)
    opt_placed = ax_b.placement_tree(opt_b.state_pds(pds))
    opt_like = {"m": shape_tree(pds, torch.float32), "v": shape_tree(pds, torch.float32),
                "step": torch.zeros((), dtype=torch.int32)}
    p_b, st_b, step, _ = ckpt.restore(d, params_like=shape_tree(pds, torch.float32),
                                      opt_like=opt_like, shardings=placed,
                                      opt_shardings=opt_placed, mesh=ax_b.mesh)
    equal = [bool(torch.equal(_full(a), b))
             for a, b in zip(tree_leaves(p_b), tree_leaves(params))]
    moments = [bool(torch.equal(_full(a), _full(b))) for a, b in
               zip(tree_leaves(st_b["m"]), tree_leaves(st_a["m"]))]
    on_target = tree_leaves(tree_map_with(lambda t, pl: t.placements == pl, p_b, placed))
    zero = tree_leaves(tree_map_with(lambda t, pl: t.placements == pl,
                                     st_b["m"], opt_placed["m"]))
    sharded_over_data = sum(t.placements[0].is_shard() for t in tree_leaves(st_b["m"]))
    return {"step": step, "equal": equal, "moments": moments,
            "on_target": on_target, "zero_on_target": zero,
            "moments_sharded_over_data": sharded_over_data}


def case_build_step(rank, inputs):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.lowering import build_step
    mesh = _mesh((2, 4))
    out = {}
    for arch in META_ARCHS:
        for name, seq, batch, kind in META_SHAPES:
            b = build_step(get_config(arch, smoke=True), mesh,
                           ShapeConfig(name, seq, batch, kind))
            out[(arch, kind)] = {k: b.meta.get(k) for k in
                                 ("param_count", "scan_trip_counts",
                                  "cache_bytes_global")}
            out[(arch, kind)]["fn_args"] = len(b.args) == len(b.in_shardings)
    return out


def case_families(rank, inputs):
    """Prefill (all logits, a cache longer than the prompt) and two decode
    steps of every family on (2, 4), against the same model unsharded."""
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.launch.lowering import place_batch
    from repro_torch.models import AxisRules, build_model, init_tree
    out = {}
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True)
        opts = {"rwkv_impl": "chunked", "rwkv_chunk": 8} if "rwkv" in arch else None
        model = build_model(cfg, AxisRules(None, opts))
        pds = model.pds()
        params = init_tree(torch.Generator().manual_seed(0), pds, torch.float32, "cpu")
        model.load_params(params)
        ax = AxisRules(_mesh((2, 4)), opts)
        sharded = build_model(cfg, ax, params=shard_params(params, pds, ax))
        g = torch.Generator().manual_seed(1)
        B, S = 4, 16
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
        if cfg.frontend == "patch":
            batch["embeds"] = torch.randn(B, 4, cfg.d_model, generator=g)
        if cfg.encoder_layers:
            batch["frames"] = torch.randn(B, 8, cfg.frontend_dim, generator=g)
        errs, scale = [], 0.0
        with torch.no_grad():
            want, c0 = model.prefill(batch, cache_len=S + 4, all_logits=True)
            got, c1 = sharded.prefill(place_batch(ax, batch), cache_len=S + 4,
                                      all_logits=True)
            errs.append(float((_full(got) - want).abs().max()))
            scale = float(want.abs().max())
            tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
            for i in range(2):
                want, c0 = model.decode(c0, tok, S + i)
                got, c1 = sharded.decode(c1, place_batch(ax, {"t": tok})["t"], S + i)
                errs.append(float((_full(got) - want).abs().max()))
        out[arch] = {"errs": errs, "scale": scale}
    return out


def case_train_run(rank, inputs):
    """``launch.train.run`` on (2, 2) against one device: two steps with a
    checkpoint, two more resumed from it on the mesh."""
    import tempfile
    from repro_torch.launch import train
    kw = dict(steps=4, seq_len=32, global_batch=4, log_every=100, device="cpu")
    one = train.run(**kw)["losses"]
    d = tempfile.mkdtemp() if rank == 0 else None
    holder = [d]
    torch.distributed.broadcast_object_list(holder, src=0)
    mesh = dict(kw, mesh_shape=(2, 2), ckpt_dir=holder[0], ckpt_every=2)
    first = train.run(**dict(mesh, steps=2))["losses"]
    resumed = train.run(**dict(mesh, steps=2, resume=True))["losses"]
    straight = train.run(**dict(kw, mesh_shape=(2, 2)))["losses"]
    return {"one": one, "mesh": straight, "resumed": first + resumed}


def case_rwkv_chunked(rank, inputs):
    """rwkv6's chunked prefill on (1, 4) (the WKV under local_map, one head
    a rank) against one device, with its final states."""
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.launch.lowering import place_batch
    from repro_torch.models import AxisRules, build_model, init_tree
    cfg = get_config("rwkv6-1.6b", smoke=True)
    opts = {"rwkv_impl": "chunked", "rwkv_chunk": 8}
    pds = build_model(cfg).pds()
    params = init_tree(torch.Generator().manual_seed(0), pds, torch.float32, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    ax = AxisRules(_mesh((1, 4)), opts)
    with torch.no_grad():
        want, c0 = build_model(cfg, AxisRules(None, opts), params=params).prefill(
            {"tokens": tokens})
        got, c1 = build_model(cfg, ax, params=shard_params(params, pds, ax)).prefill(
            place_batch(ax, {"tokens": tokens}))
    return {"logits": float((_full(got) - want).abs().max()),
            "states": max(float((_full(a["state"]) - b["state"]).abs().max())
                          for a, b in zip(c1["layers"], c0["layers"])),
            "local_heads": c1["layers"][0]["state"].to_local().shape[1]}


def case_embed(rank, inputs):
    """The vocab-sharded lookup on (1, 3) "model" ranks: a vocab of 768
    divides (local gather + sum); 512 pads to 512, which does not, and falls
    back to a plain gather.  Output and gradient against one device."""
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.launch.lowering import place_batch
    from repro_torch.models import AxisRules, build_model
    out = {}
    for vocab in (768, 512):
        cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True), vocab_size=vocab)
        emb_np, ids_np, w_np = inputs["embed"][vocab]
        pds = build_model(cfg).pds()
        res = {}
        for name, ax in (("one", AxisRules(None)), ("mesh", AxisRules(_mesh((1, 3))))):
            model = build_model(cfg, ax)
            model.embed = torch.nn.Parameter(shard_params(
                {"embed": torch.from_numpy(emb_np)}, {"embed": pds["embed"]}, ax)["embed"])
            x = model._embed(place_batch(ax, {"ids": torch.from_numpy(ids_np)})["ids"])
            w = ax.replicated(torch.from_numpy(w_np))
            if ax.mesh is not None:
                w = w.redistribute(ax.mesh, x.placements)
            (x * w).sum().backward()
            res[name] = {"x": _full(x).detach().numpy(),
                         "grad": _full(model.embed.grad).numpy(),
                         "embed_placements": str(getattr(model.embed, "placements", None))}
        out[vocab] = res
    return out


CASES = {
    8: [("train_zero1", case_train_zero1), ("moe_psum", case_moe_psum),
        ("moe_a2a", case_moe_a2a), ("reshard", case_reshard),
        ("build_step", case_build_step), ("families", case_families)],
    4: [("moe_tpff", case_moe_tpff), ("moe_data_only", case_moe_data_only),
        ("rwkv_chunked", case_rwkv_chunked),
        ("train_run", case_train_run)],
    3: [("embed", case_embed)],
}


def _rank_main(rank, world, port, inputs_path, out_dir):
    import datetime
    import logging
    import torch.distributed as dist
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    try:
        for name, fn in CASES[world]:
            try:
                res = fn(rank, inputs)
            except Exception:
                res = {"error": traceback.format_exc()}
            if rank == 0:
                with open(Path(out_dir) / f"{name}.pkl", "wb") as f:
                    pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _threaded_main(out_dir):
    """The card's kind of world on the CPU: chip_smoke's phase-``shard``
    runs at the smoke geometry, every rank a thread of this process."""
    sys.path.insert(0, str(ROOT))
    import logging
    import chip_smoke
    from repro_torch.configs import get_config
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    runs = {
        "threaded_rwkv": lambda: chip_smoke.shard_rwkv(
            get_config("rwkv6-1.6b", smoke=True), (1, 4), 32,
            {"rwkv_impl": "chunked", "rwkv_chunk": 16}, "cpu"),
        "threaded_reshard": lambda: chip_smoke.shard_reshard(
            get_config("yi-9b", smoke=True), (4,), (2, 2), "cpu",
            str(Path(out_dir) / "ckpt")),
        "threaded_grads": lambda: chip_smoke.shard_grads(
            GRAD_ARCHS, (2, 4), 4, 32, "cpu"),
    }
    for name, fn in runs.items():
        try:
            res = fn()
        except Exception:
            res = {"error": traceback.format_exc()}
        with open(Path(out_dir) / f"{name}.pkl", "wb") as f:
            pickle.dump(res, f)


def _fake_main(out_dir):
    """``make_production_mesh`` over ``fake`` process groups (rank 0 of 256
    and of 512 ranks): the meshes' shapes and names, and the rules on them."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import AxisRules
    out = {}
    for world, multi_pod in ((256, False), (512, True)):
        dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
        try:
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            ax = AxisRules(mesh)
            out[world] = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
                          "axis_sizes": ax.axis_sizes,
                          "batch_axes": ax.batch_axes,
                          "embed": ax.resolve(("vocab", "embed"), (4096, 64)),
                          "batch": ax.resolve(("batch", None), (64, 8))}
        finally:
            dist.destroy_process_group()
    try:
        make_production_mesh(device_type="cpu")
    except RuntimeError as e:
        out["uninitialised"] = str(e)
    with open(Path(out_dir) / "fake.pkl", "wb") as f:
        pickle.dump(out, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _main(argv):
    kind, out_dir = argv[0], argv[1]
    if kind == "threaded":
        return _threaded_main(out_dir)
    if kind == "fake":
        return _fake_main(out_dir)
    import torch.multiprocessing as mp
    world = int(kind)
    mp.spawn(_rank_main, args=(world, _free_port(), argv[2], out_dir), nprocs=world)


# ------------------------------------------------------------ the test side --
def _inputs(path):
    """Everything the ranks and the reference share, from seeds."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models.common import init_tree as ref_init_tree
    from repro.models.model import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro.models.common import NO_RULES
    cfg = ref_get_config("qwen3-8b", smoke=True)
    ref_params = ref_init_tree(jax.random.PRNGKey(0),
                               ref_build_model(cfg, NO_RULES).pds(), jnp.float32)
    ref_np = jax.tree_util.tree_map(np.asarray, ref_params)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4, seed=0)).batch(0)
    rng = np.random.default_rng(0)

    def moe_inputs(moe):
        from repro.configs.base import MoEConfig
        c = dataclasses.replace(ref_get_config("mixtral-8x7b", smoke=True),
                                moe=MoEConfig(**moe))
        E, d, ff = moe["num_experts"], c.d_model, moe["expert_d_ff"]
        p = {"router": rng.normal(0, 0.02, (d, E)),
             "w_in": rng.normal(0, d ** -0.5, (E, d, ff)),
             "w_gate": rng.normal(0, d ** -0.5, (E, d, ff)),
             "w_out": rng.normal(0, ff ** -0.5, (E, ff, d))}
        p = {k: v.astype(np.float32) for k, v in p.items()}
        x = rng.normal(size=(4, 8, d)).astype(np.float32)
        return p, x, rng.normal(size=x.shape).astype(np.float32)

    embed = {}
    for vocab in (768, 512):
        embed[vocab] = (rng.normal(0, 0.02, (vocab, 64)).astype(np.float32),
                        rng.integers(0, vocab, (3, 8)),
                        rng.normal(size=(3, 8, 64)).astype(np.float32))
    inputs = {
        "qwen3": (lm_params_from_reference(get_config("qwen3-8b", smoke=True),
                                           ref_np, "cpu"), batch),
        "moe_ep": moe_inputs(MOE_EP), "moe_tpff": moe_inputs(MOE_TPFF),
        "embed": embed,
    }
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    return {"qwen3_ref": ref_params, "batch": batch, **inputs}


class Worlds:
    def __init__(self, tmp: Path):
        self.tmp = tmp
        self.inputs = _inputs(tmp / "inputs.pkl")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                       p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.procs = {}
        for kind in ("8", "4", "3", "threaded", "fake"):
            out = tmp / kind
            out.mkdir()
            self.procs[kind] = subprocess.Popen(
                [sys.executable, __file__, kind, str(out), str(tmp / "inputs.pkl")],
                cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        self.logs = {}

    def result(self, kind: str, case: str):
        if kind not in self.logs:
            proc = self.procs[kind]
            try:
                self.logs[kind] = proc.communicate(timeout=WORLD_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                self.logs[kind] = proc.communicate()[0] + "\n(killed at the time limit)"
        path = self.tmp / kind / f"{case}.pkl"
        assert path.exists(), f"world {kind} wrote no {case}:\n{self.logs[kind][-4000:]}"
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert not (isinstance(res, dict) and "error" in res), res.get("error")
        return res

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("worlds"))
    yield w
    w.close()


def _ref_losses(params, batch, steps=3):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models.common import AxisRules
    from repro.models.model import build_model
    from repro.training.optimizer import AdamW, AdamWConfig, make_train_step
    ax = AxisRules(None)
    model = build_model(get_config("qwen3-8b", smoke=True), ax)
    opt = AdamW(AdamWConfig(lr=1e-3, zero1=True), ax)
    state = opt.init(params)
    step = jax.jit(make_train_step(model, opt))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        out.append(float(m["loss"]))
    return out


def test_sharded_train_step_matches_single_device(worlds):
    """The reference test's case: three ZeRO-1 steps of qwen3-8b's smoke
    geometry on (2, 4) equal one device's, the port's and the reference's,
    within its 5e-3; remat="full" on the mesh changes nothing; every
    moment of the first layer's attention is split over "data"."""
    ref = _ref_losses(worlds.inputs["qwen3_ref"], worlds.inputs["batch"])
    res = worlds.result("8", "train_zero1")
    np.testing.assert_allclose(res["one"], ref, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(res["mesh"], ref, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(res["mesh"], res["one"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["remat"], res["mesh"][:2], rtol=1e-6, atol=1e-6)
    assert all(res["moments_split_over_data"]), res["moments_split_over_data"]


def _ref_moe(inputs, moe):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import MoEConfig
    from repro.models.common import NO_RULES
    from repro.models.moe import moe_apply
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              moe=MoEConfig(**moe))
    p, x, _ = inputs
    y, aux = jax.jit(lambda p, x: moe_apply(cfg, p, x, NO_RULES, train=True))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    return np.asarray(y), float(aux["moe_drop_frac"])


def _check_moe(worlds, world, case, key, moe):
    y_ref, drop_ref = _ref_moe(worlds.inputs[key], moe)
    res = worlds.result(world, case)
    assert drop_ref == res["one"]["drop"] == res["mesh"]["drop"] == 0.0
    np.testing.assert_allclose(res["one"]["y"], y_ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(res["mesh"]["y"], y_ref, atol=2e-5, rtol=2e-5)
    for k, g in res["one"]["grads"].items():
        np.testing.assert_allclose(res["mesh"]["grads"][k], g, atol=2e-5, rtol=2e-5,
                                   err_msg=k)
    np.testing.assert_allclose(res["mesh"]["gx"], res["one"]["gx"], atol=2e-5, rtol=2e-5)


def test_moe_expert_parallel_psum_matches_single_device(worlds):
    """EP on (2, 4): 2 experts a rank, each selecting its tokens locally and
    combining by a sum over "model"; dropless, as the reference's test."""
    _check_moe(worlds, "8", "moe_psum", "moe_ep", MOE_EP)


def test_moe_expert_parallel_all_to_all_matches_single_device(worlds):
    """The same layer with tokens sharded over batch and sequence and shipped
    to their experts' ranks by two tiled all-to-alls."""
    _check_moe(worlds, "8", "moe_a2a", "moe_ep", MOE_EP)


def test_moe_tp_over_d_ff_matches_single_device(worlds):
    """TPFF: 2 experts on 4 "model" ranks (E % tp != 0), every rank holding
    both experts with a quarter of their d_ff."""
    _check_moe(worlds, "4", "moe_tpff", "moe_tpff", MOE_TPFF)


def test_moe_on_a_mesh_without_a_model_axis(worlds):
    """A (4,) "data" mesh (tp = 1): the reference runs its one-device body on
    the global arrays; every rank here runs it on the whole batch."""
    _check_moe(worlds, "4", "moe_data_only", "moe_ep", MOE_EP)


def test_checkpoint_elastic_reshard(worlds):
    """Saved on (8,) and restored onto (2, 4): every parameter and moment
    byte-equal, on the target mesh's placements (moments under ZeRO-1)."""
    res = worlds.result("8", "reshard")
    assert res["step"] == 5
    assert all(res["equal"]) and len(res["equal"]) > 10
    assert all(res["moments"]) and all(res["on_target"]) and all(res["zero_on_target"])
    assert res["moments_sharded_over_data"] > 0


@pytest.mark.parametrize("arch", META_ARCHS)
def test_build_step_meta_equals_reference(worlds, arch):
    """``build_step``'s parameter count, scan trip counts and global cache
    bytes for train, prefill and decode equal the reference's on a (1, 1)
    jax mesh."""
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch.lowering import build_step
    from repro.launch.mesh import make_mesh
    res = worlds.result("8", "build_step")
    mesh = make_mesh((1, 1), ("data", "model"))
    for name, seq, batch, kind in META_SHAPES:
        b = build_step(get_config(arch, smoke=True), mesh,
                       ShapeConfig(name, seq, batch, kind))
        got = res[(arch, kind)]
        assert got["fn_args"]
        for key in ("param_count", "scan_trip_counts", "cache_bytes_global"):
            assert got[key] == b.meta.get(key), (arch, kind, key)


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_prefill_and_decode_match_single_device(worlds, arch):
    """Every family's prefill and two decode steps through the sharded cache
    on (2, 4), within 2e-5 of the largest logit of the unsharded model (held
    to the reference by the single-device tests)."""
    res = worlds.result("8", "families")[arch]
    assert res["scale"] > 0
    assert max(res["errs"]) <= 2e-5 * max(res["scale"], 1.0), res


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_sharded_gradients_match_single_device(worlds, arch):
    """chip_smoke's phase-``shard`` run (e) in the threaded world: one loss
    within 1e-5 and every gradient within 1e-4 of its largest of the
    unsharded model's, on (2, 4), where yi-9b and mixtral-8x7b repeat their
    2 KV heads over 4 ranks (``AxisRules.shared_product``) and rwkv6-1.6b
    splits its decay LoRA and takes ``u``'s gradient from each rank's rows."""
    res = worlds.result("threaded", "threaded_grads")
    row = {r["arch"]: r for r in res["archs"]}[arch]
    assert row["loss_rel"] <= 1e-5 and row["grad_rel"] <= 1e-4, res


def test_train_run_on_a_mesh(worlds):
    """``launch.train.run(mesh_shape=(2, 2))`` gives one device's losses
    within 5e-3, and so does a run checkpointed at step 2 and resumed on the
    mesh through ``restore(shardings=, opt_shardings=)``."""
    res = worlds.result("4", "train_run")
    np.testing.assert_allclose(res["mesh"], res["one"], rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(res["resumed"], res["one"], rtol=5e-3, atol=5e-3)


def test_rwkv_chunked_prefill_sharded_over_heads(worlds):
    res = worlds.result("4", "rwkv_chunked")
    assert res["local_heads"] == 1
    assert res["logits"] <= 2e-5 and res["states"] <= 2e-5, res


@pytest.mark.parametrize("vocab", [768, 512])
def test_vocab_sharded_embedding(worlds, vocab):
    """On 3 "model" ranks a 768 vocab shards (a third a rank, gathered
    locally, masked and summed) and 512 does not divide, so it falls back to
    the plain gather of a replicated table, as the reference's ``_embed``
    does; both equal the reference's lookup, and their gradients one
    device's."""
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models.common import NO_RULES
    from repro.models.model import LM
    emb, ids, _ = worlds.inputs["embed"][vocab]
    cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True), vocab_size=vocab)
    want = np.asarray(LM(cfg, NO_RULES)._embed({"embed": jnp.asarray(emb)},
                                                jnp.asarray(ids)))
    res = worlds.result("3", "embed")[vocab]
    np.testing.assert_array_equal(res["one"]["x"], want)
    np.testing.assert_array_equal(res["mesh"]["x"], want)
    np.testing.assert_allclose(res["mesh"]["grad"], res["one"]["grad"], atol=1e-6)
    sharded = "Shard(dim=0)" in res["mesh"]["embed_placements"]
    assert sharded == (vocab == 768), res["mesh"]["embed_placements"]


@pytest.mark.parametrize("case", ["threaded_rwkv", "threaded_reshard"])
def test_threaded_world_on_the_cpu(worlds, case):
    """chip_smoke's phase ``shard`` runs, at the smoke geometry, in the card's
    kind of world: every rank a thread of one process (``threaded``)."""
    res = worlds.result("threaded", case)
    assert res["failures"] == [], res


def test_make_production_mesh_on_fake_process_groups(worlds):
    res = worlds.result("fake", "fake")
    assert res[256]["shape"] == (16, 16) and res[256]["names"] == ("data", "model")
    assert res[512]["shape"] == (2, 16, 16)
    assert res[512]["names"] == ("pod", "data", "model")
    assert res[512]["batch_axes"] == ("pod", "data")
    assert res[256]["embed"] == ("model", None)
    assert res[512]["batch"] == (("pod", "data"), None)
    assert "process group" in res["uninitialised"]


if __name__ == "__main__":
    _main(sys.argv[1:])
