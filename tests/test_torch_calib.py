"""The port's calibration flow against the reference's: identical grids,
identical kernelsim fits and provenance, artifacts that cross-load both ways,
and the kernel oracle timed on the CPU."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.calib as R
import repro.configs as R_configs
import repro.core.hardware as R_hw
import repro_torch.calib as T
import repro_torch.configs as T_configs
import repro_torch.core.hardware as T_hw
from repro_torch import convert
from repro_torch.api import cli

LIMITS = {"max_len": 8192, "max_batch": 64, "max_tokens": 8192}


@pytest.mark.parametrize("model", ["qwen2-7b", "mixtral-8x7b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_grids_identical(model, smoke):
    r = R.build_grid(R_configs.get_config(model, smoke=smoke), n_train=20,
                     n_eval=8, seed=3, limits=LIMITS, max_len=4096, max_batch=16)
    t = T.build_grid(T_configs.get_config(model, smoke=smoke), n_train=20,
                     n_eval=8, seed=3, limits=LIMITS, max_len=4096, max_batch=16)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)


@pytest.mark.parametrize("model", ["qwen2-7b", "mixtral-8x7b"])
def test_kernelsim_calibration_equals_reference(model, tmp_path):
    kw = dict(model=model, hardware="H100-SXM", oracle="kernelsim", smoke=True,
              n_train=40, n_eval=12, seed=0)
    r = R.calibrate(out_root=str(tmp_path / "ref"), **kw)
    t = T.calibrate(out_root=str(tmp_path / "port"), device="cpu", **kw)
    assert sorted(r.artifacts) == sorted(t.artifacts)
    assert r.fidelity == t.fidelity
    assert r.limits == t.limits
    for op in r.artifacts:
        ra, ta = r.artifacts[op], t.artifacts[op]
        assert ra.forest == ta.forest
        assert ra.geometry == ta.geometry
        assert ra.provenance_hash() == ta.provenance_hash()
        assert ra.spec_hash == ta.spec_hash and ta.spec_hash
        with open(r.artifact_paths[op]) as f, open(t.artifact_paths[op]) as g:
            rd, td = json.load(f), json.load(g)
        rd.pop("created_at"), td.pop("created_at")
        assert rd == td


def test_artifacts_cross_load_both_ways(tmp_path):
    kw = dict(model="mixtral-8x7b", hardware="H100-SXM", oracle="kernelsim",
              smoke=True, n_train=30, n_eval=8, seed=2)
    r = R.calibrate(out_root=str(tmp_path / "ref"), **kw)
    t = T.calibrate(out_root=str(tmp_path / "port"), device="cpu", **kw)
    q, kv = [40, 17, 90], [40, 17, 90]
    counts = [12, 0, 40, 3]
    # reference JSON -> port
    for op, path in r.artifact_paths.items():
        with open(path) as f:
            art = convert.artifact_from_reference(json.load(f))
        assert art.spec_hash == r.artifacts[op].spec_hash
        fitted = art.to_fitted()
        ref_fitted = r.artifacts[op].to_fitted()
        if op == "attention":
            assert fitted.predict(q, kv, causal=True, window=0) == \
                ref_fitted.predict(q, kv, causal=True, window=0)
        else:
            assert fitted.predict(counts) == ref_fitted.predict(counts)
    # reference directory loads in the port as it stands
    r_cfg = R_configs.get_config("mixtral-8x7b", smoke=True)
    t_cfg = T_configs.get_config("mixtral-8x7b", smoke=True)
    r_ops = R.load_calibrated_ops(str(tmp_path / "ref"), r_cfg, R_hw.H100_SXM)
    t_ops = T.load_calibrated_ops(str(tmp_path / "ref"), t_cfg, T_hw.H100_SXM)
    g = T.geometry_of(t_cfg)
    args = (g["n_heads"], g["n_kv_heads"], g["head_dim"])
    assert r_ops.attention_prefill(q, kv, *args) == t_ops.attention_prefill(q, kv, *args)
    assert r_ops.attention_decode(kv, *args) == t_ops.attention_decode(kv, *args)
    mg = T.moe_geometry_of(t_cfg)
    assert r_ops.grouped_gemm(counts, mg["d_in"], mg["d_out"]) == \
        t_ops.grouped_gemm(counts, mg["d_in"], mg["d_out"])
    # port -> reference
    for op, art in t.artifacts.items():
        back = R.CalibrationArtifact.from_dict(convert.artifact_to_reference(art))
        assert back.forest == r.artifacts[op].forest
        assert back.provenance_hash() == r.artifacts[op].provenance_hash()
    r_ops2 = R.load_calibrated_ops(str(tmp_path / "port"), r_cfg, R_hw.H100_SXM)
    assert r_ops2.attention_decode(kv, *args) == t_ops.attention_decode(kv, *args)


def test_convert_maps_real_kernel_oracle_names():
    art = T.CalibrationArtifact(
        operator="attention", hardware="H100-SXM", model="m", oracle="kernels",
        geometry={"n_heads": 4, "n_kv_heads": 2, "head_dim": 64}, seed=0,
        n_train=1, metrics={}, forest={})
    data = convert.artifact_to_reference(art)
    assert data["oracle"] == "pallas"
    assert convert.artifact_from_reference(data).oracle == "kernels"


def test_kernel_oracle_on_cpu_times_plain_versions_and_caches():
    orc = T.KernelOracle(T_hw.HARDWARE["A800-SXM4-80G"], device="cpu", reps=1)
    assert orc.limits() == {"max_len": 160, "max_batch": 4, "max_tokens": 512}
    t_pre = orc.attention_prefill([16, 24], [16, 24], 2, 2, 16)
    t_dec = orc.attention_decode([16, 32], 2, 2, 16)
    t_gg = orc.grouped_gemm([8, 16], 32, 32)
    assert t_pre > 0 and t_dec > 0 and t_gg > 0
    n_cached = len(orc._cache)
    assert orc.attention_prefill([16, 24], [16, 24], 2, 2, 16) == t_pre
    assert orc.attention(([1, 1]), [16, 32], 2, 2, 16, causal=False) == t_dec
    assert len(orc._cache) == n_cached      # second call is a pure cache hit
    # the reference's cache keys
    assert ("prefill", 16, 16, 2, 2, 16, True, 0) in orc._cache
    assert ("prefill", 32, 32, 2, 2, 16, True, 0) in orc._cache
    assert ("decode", 2, 32, 2, 2, 16, 0) in orc._cache
    assert ("grouped", 2, 16, 32, 32) in orc._cache


def test_kernel_oracle_buckets_equal_the_reference():
    ref = R.PallasOracle(R_hw.HARDWARE["H100-SXM"], reps=1)
    port = T.KernelOracle(T_hw.HARDWARE["H100-SXM"], device="cpu", reps=1)
    ns = list(range(1, 600)) + [1000, 2048, 4095, 4096, 8191, 8192, 20000]
    assert [ref._round(n) for n in ns] == [port._round(n) for n in ns]


def test_kernel_oracle_accelerator_limits():
    orc = T.KernelOracle.__new__(T.KernelOracle)
    orc._on_accel = True
    assert orc.limits() == {"max_len": 8192, "max_batch": 64, "max_tokens": 8192}


def test_auto_oracle_is_kernels_and_raises_without_cuda():
    assert T.default_oracle_name() == "kernels"
    assert sorted(T.ORACLES) == ["kernels", "kernelsim"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: auto resolves and runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.resolve_oracle("auto", T_hw.H100_SXM)            # device="cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        T.calibrate(model="qwen2-7b", hardware="H100-SXM", oracle="auto",
                    smoke=True, n_train=2, n_eval=2, out_root=None)
    # by name, the simulator is still there
    assert T.resolve_oracle("kernelsim", T_hw.H100_SXM).name == "kernelsim"


def test_calibrate_with_kernel_oracle_on_cpu(tmp_path):
    res = T.calibrate(model="mixtral-8x7b", hardware="H100-SXM",
                      oracle="kernels", smoke=True, n_train=10, n_eval=4,
                      out_root=str(tmp_path), device="cpu")
    assert res.oracle == "kernels" and res.limits["max_len"] == 160
    assert set(res.fidelity) == {"attention", "grouped_gemm"}
    for fams in res.fidelity.values():
        for stats in fams.values():
            assert np.isfinite(stats["mape"])
    cfg = T_configs.get_config("mixtral-8x7b", smoke=True)
    ops = T.load_calibrated_ops(str(tmp_path), cfg, T_hw.H100_SXM)
    assert ops.attention is not None and ops.grouped is not None


def test_cli_calibrate_on_cpu(tmp_path, capsys):
    out = tmp_path / "calib"
    fid = tmp_path / "FIDELITY_torch.json"
    rc = cli.main(["calibrate", "--device", "cpu", "--oracle", "kernelsim",
                   "--model", "qwen2-7b", "--smoke", "--hardware", "H100-SXM",
                   "--train-samples", "30", "--eval-samples", "8",
                   "-o", str(out), "--fidelity", str(fid), "--label", "t"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "calibrated qwen2-7b-smoke on H100-SXM (oracle=kernelsim" in text
    assert (out / "H100-SXM" / "attention.json").is_file()
    traj = T.load_trajectory(str(fid))
    assert len(traj) == 1 and traj[0]["label"] == "t"
    ok, _ = T.check_fidelity_regression(traj[0], traj)
    assert ok


def test_cli_surface():
    with pytest.raises(SystemExit):
        cli.main(["run", "spec.yaml"])         # not registered yet
    with pytest.raises(SystemExit):
        cli.main(["calibrate", "--oracle", "pallas"])
    assert cli.main(["calibrate", "--device", "cpu", "--oracle", "kernelsim",
                     "--hardware", "nope", "--no-fidelity"]) == 2
