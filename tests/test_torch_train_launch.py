"""Twins of the reference's trainer tests (``tests/test_training.py``) on the
port's ``repro_torch.launch.train``, on the CPU, and a checkpoint of the
reference's trainer continued in the port.

Tolerances are the reference test's: a loss drop of 0.3 over 30 steps, and a
resumed run's last loss within 2e-4 of a straight run's.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.train import run as ref_run
from repro.models import AxisRules as RefAxisRules
from repro.models import build_model as ref_build_model
from repro.models.common import is_pd
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.train import main, run
from repro_torch.training import checkpoint as ckpt

RESUME_TOL = dict(rtol=2e-4, atol=2e-4)


def test_loss_drops_over_training():
    out = run("yi-9b", smoke=True, steps=30, seq_len=64, global_batch=4,
              lr=2e-3, log_every=100, device="cpu")
    assert out["last_loss"] < out["first_loss"] - 0.3
    assert len(out["losses"]) == len(out["step_s"]) == 30


def test_checkpoint_roundtrip_and_resume(tmp_path):
    d = str(tmp_path / "ck")
    kw = dict(smoke=True, seq_len=32, global_batch=2, log_every=100, seed=7,
              device="cpu")
    run("qwen3-8b", steps=10, ckpt_dir=d, ckpt_every=10, **kw)
    assert ckpt.latest_step(d) == 10
    manifest = json.loads((tmp_path / "ck" / "step_00000010" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 10 and manifest["extra"]["arch"] == "qwen3-8b-smoke"
    assert "params/layers/1/attn/wq" in manifest["keys"]
    assert {"opt/step", "opt/m/embed", "opt/v/layers/0/mlp/w_in"} <= set(manifest["keys"])
    # a resumed run continues from step 10 deterministically: the combined
    # trajectory must equal a single 20-step run (same seed/data function)
    out2 = run("qwen3-8b", steps=10, ckpt_dir=d, ckpt_every=0, resume=True, **kw)
    out_full = run("qwen3-8b", steps=20, **kw)
    np.testing.assert_allclose(out2["last_loss"], out_full["last_loss"],
                               **RESUME_TOL)
    assert int(out2["opt_state"]["step"]) == 20


def test_checkpoint_atomicity_prunes_tmp(tmp_path):
    d = tmp_path / "ck2"
    p = {"w": torch.ones((4, 4))}
    ckpt.save(str(d), params=p, step=1)
    # a stale tmp dir from a "crashed" writer is pruned on the next save
    stale = d / ".tmp_step_00000009_999"
    stale.mkdir()
    ckpt.save(str(d), params=p, step=2)
    assert not stale.exists()
    assert ckpt.latest_step(str(d)) == 2


def test_restore_casts_to_the_like_tree(tmp_path):
    d = str(tmp_path / "ck3")
    params = {"w": torch.randn(3, 5).to(torch.bfloat16),
              "layers": ({"b": torch.arange(4.0)},)}
    opt = {"step": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(d, params=params, opt_state=opt, step=3, extra={"k": 1})
    got, got_opt, step, extra = ckpt.restore(d, params_like=params, opt_like=opt)
    assert (step, extra) == (3, {"k": 1})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], params["w"])
    assert isinstance(got["layers"], tuple)
    assert torch.equal(got["layers"][0]["b"], params["layers"][0]["b"])
    assert got_opt["step"].dtype == torch.int32 and int(got_opt["step"]) == 7
    with pytest.raises(ValueError, match="mesh="):     # placements need their mesh
        ckpt.restore(d, params_like=params, shardings={})


def test_unported_and_unavailable_options_raise():
    with pytest.raises(RuntimeError, match="process group"):   # none set up here
        run("yi-9b", steps=1, mesh_shape=(2, 1), device="cpu")
    with pytest.raises(ValueError):
        run("yi-9b", steps=1, remat="some", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run("yi-9b", steps=1)


def test_cli_trains_on_the_cpu(capsys, tmp_path):
    main(["--device", "cpu", "--steps", "3", "--arch", "qwen3-8b",
          "--seq-len", "16", "--global-batch", "2", "--layers", "1",
          "--remat", "full", "--seed", "3", "--ckpt-dir", str(tmp_path),
          "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "checkpoint ->" in out
    assert out.strip().splitlines()[-1].startswith("loss: ")
    assert ckpt.latest_step(str(tmp_path)) == 3


def _read_reference_checkpoint(cfg_name, path, step):
    """A checkpoint of the reference's trainer, read with numpy into the
    reference's trees (its flattened keys follow ``tree_flatten_with_path``)."""
    rmodel = ref_build_model(ref_get_config(cfg_name, smoke=True), RefAxisRules(None))
    pds = rmodel.pds()
    with np.load(f"{path}/step_{step:08d}/tensors.npz") as blobs:
        def tree(prefix, like):
            flat, treedef = jax.tree_util.tree_flatten_with_path(like, is_leaf=is_pd)
            keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                             for p in kp) for kp, _ in flat]
            return jax.tree_util.tree_unflatten(
                treedef, [blobs[f"{prefix}/{k}"] for k in keys])
        params = tree("params", pds)
        opt = {"m": tree("opt/m", pds), "v": tree("opt/v", pds),
               "step": blobs["opt/step"]}
    return params, opt


def test_reference_checkpoint_continues_in_the_port(tmp_path):
    """10 steps of the reference's trainer, its checkpoint carried in by
    ``convert.train_state_from_reference``, then 10 steps of the port: the
    last loss equals the reference's straight 20-step run within 2e-4."""
    kw = dict(smoke=True, seq_len=32, global_batch=2, log_every=100, seed=7)
    ref_dir = str(tmp_path / "ref")
    ref_run("qwen3-8b", steps=10, ckpt_dir=ref_dir, ckpt_every=10, **kw)
    want = ref_run("qwen3-8b", steps=20, **kw)["last_loss"]

    cfg = get_config("qwen3-8b", smoke=True)
    ref_params, ref_opt = _read_reference_checkpoint("qwen3-8b", ref_dir, 10)
    params, opt = convert.train_state_from_reference(cfg, ref_params, ref_opt, "cpu")
    assert int(opt["step"]) == 10
    # and back: the reverse conversion gives the reference's arrays
    back_p, back_o = convert.train_state_to_reference(cfg, params, opt)
    for a, b in zip(jax.tree_util.tree_leaves((back_p, back_o)),
                    jax.tree_util.tree_leaves((ref_params, ref_opt))):
        np.testing.assert_array_equal(a, b)

    port_dir = str(tmp_path / "port")
    ckpt.save(port_dir, params=params, opt_state=opt, step=10)
    got = run("qwen3-8b", steps=10, ckpt_dir=port_dir, ckpt_every=0,
              resume=True, device="cpu", **kw)["last_loss"]
    np.testing.assert_allclose(got, want, **RESUME_TOL)
