"""The port's dry run (``repro_torch.launch.{lowering.lower_step, dryrun}``)
against the reference's, on the CPU.

The reference lowers each step onto 8 forced XLA host devices and reads its
compiled HLO with ``hlo_cost.analyze``; that runs once, in a subprocess, as
``tests/test_distributed.py`` runs its multi-device cases.  The port runs the
same steps in this process on a ``fake`` process group of 8 ranks, on fake
CPU tensors (``device="cpu"``: a torch built without CUDA refuses autograd
and some ops on fake CUDA tensors; with CUDA the default ``"cuda"`` runs),
and counts them with ``hlo_cost.Counter``.  Smoke widths, a (2, 4)
mesh, the three step kinds of yi-9b, mixtral-8x7b and rwkv6-1.6b.

Per-device flops agree within 1 % (prefill, decode) and 2 % (train).  On
one device the port's prefill projects q/k/v once and fills the cache from
the core's k/v (``attention.attention_prefill``), where the reference
projects twice and XLA eliminates the second as a common subexpression: the
counts are compared as they are.  Under tensor parallelism both packages
project the cache's k/v a second time (the core's are laid out otherwise);
eager torch runs all of it, XLA all but what ``XLA_KEEPS`` pins (ROADMAP
Queue C, "No HLO").  On the (2, 4) mesh the train steps differ within 2 %:
mixtral-8x7b +0.25 % (GSPMD splits the router's weight gradient over two
ranks, the port computes it whole),
rwkv6-1.6b -1.43 % (``AxisRules.shared_product`` splits the decay LoRA's
weight gradient over the four "model" ranks, GSPMD over two).
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["yi-9b", "mixtral-8x7b", "rwkv6-1.6b"]
KINDS = {"train": ("mini_train", 32, 4, "train"),
         "prefill": ("mini_prefill", 64, 4, "prefill"),
         "decode": ("mini_dec", 64, 4, "decode")}
CELLS = [(a, k) for a in ARCHS for k in KINDS]
TOL = {"train": 0.02, "prefill": 0.01, "decode": 0.01}

_REFERENCE = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.launch.lowering import build_step, lower_step
from repro.launch import hlo_cost
out = {}
for mesh_shape in ((2, 4), (1, 1)):
    mesh = make_mesh(mesh_shape, ("data", "model"))
    for arch, kind in CELLS:
        shape = ShapeConfig(*KINDS[kind])
        comp = lower_step(build_step(get_config(arch, smoke=True), mesh, shape),
                          mesh).compile()
        mem = comp.memory_analysis()
        out[f"{mesh_shape}/{arch}/{kind}"] = dict(
            hlo_cost.analyze(comp.as_text()),
            argument_bytes=mem.argument_size_in_bytes)
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    prog = (f"CELLS = {CELLS!r}\nKINDS = {KINDS!r}\n"
            + textwrap.dedent(_REFERENCE))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=600, cwd=str(ROOT),
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def port():
    import logging
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.lowering import build_step, lower_step
    from repro_torch.launch.mesh import make_mesh
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    out = {}
    for mesh_shape in ((2, 4), (1, 1)):
        with fake_world(mesh_shape[0] * mesh_shape[1]):
            mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
            for arch, kind in CELLS:
                bundle = build_step(get_config(arch, smoke=True), mesh,
                                    ShapeConfig(*KINDS[kind]))
                comp = lower_step(bundle, mesh, device="cpu").compile()
                out[f"{mesh_shape}/{arch}/{kind}"] = (comp.cost_analysis(),
                                                      comp.memory_analysis())
    return out


# Flops a device of the prefill's second projection that XLA keeps on the
# (2, 4) mesh, where the port runs it whole (``_recomputed_projection``):
# yi-9b the cache's k projection over the rank's quarter of the sequence
# (its "kv_seq" split), mixtral-8x7b nothing.  Before the repeated
# KV heads were projected per rank and decode attention split over the
# cache's slots, the port counted 1.04-1.52 of the reference on every cell
# of this mesh (ROADMAP Queue C5).
XLA_KEEPS = {"yi-9b": 262144, "mixtral-8x7b": 0}


def _recomputed_projection(arch: str, kind: str, mesh=(2, 4)) -> float:
    """The flops a device of the q/k/v projection that a prefill runs a
    second time to fill the cache under tensor parallelism
    (``attention.attention_prefill``; the reference's ``block_prefill``): on
    a ("data", "model") mesh the rank's rows, its query heads and its KV
    heads (all of them unless they divide "model")."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
    cfg = get_config(arch, smoke=True)
    kinds = cfg.block_pattern * (cfg.num_layers // len(cfg.block_pattern))
    n_attn = sum(k in (ATTN_GLOBAL, ATTN_LOCAL) for k in kinds)
    if kind != "prefill":
        return 0.0
    _, S, B, _ = KINDS[kind]
    data, tp = mesh
    H, K = cfg.num_heads, cfg.num_kv_heads
    heads = H // tp if H % tp == 0 else H
    heads += 2 * (K // tp if K % tp == 0 else K)
    return 2.0 * (B // data) * S * cfg.d_model * heads * cfg.resolved_head_dim * n_attn


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_on_one_device(reference, port, arch, kind):
    """On a (1, 1) mesh the counter and ``analyze`` count the same products:
    the port's prefill projects q/k/v once, the reference's twice with XLA
    eliminating the second."""
    key = f"{(1, 1)}/{arch}/{kind}"
    got = port[key][0]["flops"]
    assert got == pytest.approx(reference[key]["flops"], rel=TOL[kind])


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_per_device_on_a_mesh(reference, port, arch, kind):
    """On (2, 4) as on one device, but for the prefill's second projection,
    which the port runs whole and XLA in part (``XLA_KEEPS``), held exactly."""
    key = f"{(2, 4)}/{arch}/{kind}"
    got = port[key][0]["flops"] - _recomputed_projection(arch, kind, (2, 4))
    want = reference[key]["flops"]
    if kind == "prefill" and arch in XLA_KEEPS:
        assert got + XLA_KEEPS[arch] == want
    else:
        assert got == pytest.approx(want, rel=TOL[kind])


@pytest.mark.parametrize("arch,kind", CELLS)
def test_argument_bytes_equal(reference, port, arch, kind):
    """Each rank's argument bytes equal the reference's, on the mesh and on
    one device.  XLA drops an argument its step never reads: rwkv6's decode
    does not read the position, whose 4 bytes the port keeps."""
    unread = 4 if (arch, kind) == ("rwkv6-1.6b", "decode") else 0
    for mesh in ((2, 4), (1, 1)):
        key = f"{mesh}/{arch}/{kind}"
        assert port[key][1].argument_bytes == reference[key]["argument_bytes"] + unread


def test_memory_analysis_fields(port):
    mem = port[f"{(2, 4)}/yi-9b/train"][1]
    assert mem.generated_code_bytes is None          # eager generates no code
    assert mem.alias_bytes < mem.argument_bytes      # params and moments, not the batch
    assert mem.temp_bytes > 0 and mem.output_bytes > 0
    dec = port[f"{(2, 4)}/yi-9b/decode"][1]
    assert 0 < dec.alias_bytes < dec.argument_bytes  # the cache is donated


def test_collectives_per_kind_use_the_reference_names(port):
    from repro.launch.hlo_cost import COLLECTIVES
    for costs, _ in port.values():
        kinds = {k[len("coll_"):] for k in costs if k.startswith("coll_")}
        assert kinds <= set(COLLECTIVES)
        assert costs["collective_bytes"] == pytest.approx(
            sum(costs[f"coll_{k}"] for k in kinds))
    assert port[f"{(1, 1)}/yi-9b/train"][0]["collective_bytes"] == 0


# ----------------------------------------------------------------- dryrun --
REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "tag", "n_chips", "step",
                  "meta", "lower_s", "compile_s", "memory_analysis",
                  "cost_analysis_raw", "hlo_corrected"}


@pytest.fixture
def smoke_dryrun(monkeypatch):
    """``dryrun`` with the smoke geometries: the cells' shapes and meshes are
    the production ones, the widths the tests'."""
    import logging
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a, smoke=True))
    return dryrun


def test_run_cell_record_has_the_reference_keys(smoke_dryrun):
    rec = smoke_dryrun.run_cell("mixtral-8x7b", "decode_32k", False,
                                tag="t", device="cpu")
    assert REFERENCE_KEYS <= set(rec)
    assert set(rec) - REFERENCE_KEYS == {"package", "kernels"}
    assert rec["status"] == "ok" and rec["package"] == "repro_torch"
    assert rec["n_chips"] == 256 and rec["step"] == "serve_step"
    assert rec["meta"]["mesh"] == {"data": 16, "model": 16}
    assert rec["cost_analysis_raw"] == rec["hlo_corrected"]
    assert rec["hlo_corrected"]["flops"] > 0
    assert set(rec["memory_analysis"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "generated_code_bytes"}
    assert not torch.distributed.is_initialized()   # the fake world is gone


def test_skipped_cells_equal_the_reference():
    """``run_cell`` skips a cell, with the reference's reason, exactly where
    the reference's ``shape_applicable`` refuses it (before any world is
    made: no full-width step runs in this test)."""
    import repro.configs as R
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch.dryrun import run_cell
    assert ARCH_IDS == R.ARCH_IDS and list(SHAPES) == list(R.SHAPES)
    n_skipped = 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, why = R.shape_applicable(R.get_config(arch), R.SHAPES[shape])
            if ok:
                continue
            n_skipped += 1
            for multi_pod in (False, True):
                rec = run_cell(arch, shape, multi_pod)
                assert rec == {"arch": arch, "shape": shape,
                               "mesh": "multipod" if multi_pod else "pod",
                               "status": "skipped", "reason": why}
    assert n_skipped > 0


def test_main_writes_the_record_and_exits_0(smoke_dryrun, tmp_path, capsys):
    smoke_dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k", "--mesh", "pod",
                       "--tag", "t", "--out", str(tmp_path), "--device", "cpu"])
    assert "dry-run complete" in capsys.readouterr().out
    rec = json.loads((tmp_path / "yi-9b__decode_32k__pod__t.json").read_text())
    assert rec["status"] == "ok" and rec["hlo_corrected"]["flops"] > 0


def test_main_records_a_failing_cell_and_exits_1(smoke_dryrun, tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("made to fail")
    monkeypatch.setattr(smoke_dryrun, "lower_step", broken)
    with pytest.raises(SystemExit) as exc:
        smoke_dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k",
                           "--tag", "t", "--out", str(tmp_path), "--device", "cpu"])
    assert exc.value.code == 1
    rec = json.loads((tmp_path / "yi-9b__decode_32k__pod__t.json").read_text())
    assert rec["status"] == "error" and "made to fail" in rec["error"]
    assert not torch.distributed.is_initialized()


def test_a_train_step_on_fake_cuda_needs_a_cuda_build():
    """On torch built without CUDA, autograd refuses fake CUDA tensors with
    a C++ abort; ``lower_step`` raises first, and says what to pass."""
    if torch.backends.cuda.is_built():
        pytest.skip("this torch is built with CUDA: fake CUDA train steps run")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.lowering import build_step, lower_step
    from repro_torch.launch.mesh import make_mesh
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        bundle = build_step(get_config("yi-9b", smoke=True), mesh,
                            ShapeConfig(*KINDS["train"]))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lower_step(bundle, mesh, device="cuda")


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_tensor_parallel_backward_runs_each_rank_its_share(port):
    """On a (1, 4) mesh ("model" only) a rank's train step counts 1.048 of an
    even quarter of the step on one device: each rank projects the one KV
    head its query heads read (2 KV heads over 4 ranks), forward and in the
    input's gradient, half of the K/V projections where a quarter would be
    even; nothing else runs above its share.  Before ``constrain`` summed
    the TP regions' Partial gradients it counted 1.643 (every backward
    product of a TP region ran whole), and 1.214 before ``shared_product``
    (the K/V projections ran whole, forward and backward)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.lowering import build_step, lower_step
    from repro_torch.launch.mesh import make_mesh
    with fake_world(4):
        mesh = make_mesh((1, 4), ("data", "model"), "cpu")
        bundle = build_step(get_config("yi-9b", smoke=True), mesh,
                            ShapeConfig(*KINDS["train"]))
        flops = lower_step(bundle, mesh, device="cpu").compile().cost_analysis()["flops"]
    whole = port[f"{(1, 1)}/yi-9b/train"][0]["flops"]
    assert 4 * flops / whole == pytest.approx(1.048, abs=0.001)
    assert _chip_smoke().COUNTER_CELLS["yi-9b", "train", (1, 4)] == flops


def test_chip_smoke_holds_the_card_to_these_counts(port):
    """``chip_smoke.COUNTER_CELLS``, which phase ``cost`` counts again with
    the card's torch and holds exactly, is what the counter gives here."""
    chip_smoke = _chip_smoke()
    assert chip_smoke.COUNTER_SHAPES == KINDS
    mesh = {k: v for k, v in chip_smoke.COUNTER_CELLS.items() if k[2] == (2, 4)}
    assert set(mesh) == {(a, k, (2, 4)) for a, k in CELLS}
    for (arch, kind, _), flops in mesh.items():
        assert port[f"{(2, 4)}/{arch}/{kind}"][0]["flops"] == flops
