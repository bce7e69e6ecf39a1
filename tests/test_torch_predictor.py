"""The port's ExecutionPredictor against the reference's: step parts bit for
bit with the python and numpy backends, the fused float32 backend within the
reference's own gate, and MoE routing draws in the same RNG order."""
import numpy as np
import pytest

import repro.calib as R_calib
import repro.configs as R_configs
import repro.core.hardware as R_hw
import repro.core.opmodels as R_op
import repro.core.predictor as R_pred
import repro.core.routing as R_rt
import repro_torch.calib as T_calib
import repro_torch.configs as T_configs
import repro_torch.core.hardware as T_hw
import repro_torch.core.opmodels as T_op
import repro_torch.core.predictor as T_pred
import repro_torch.core.routing as T_rt
from repro_torch.core.opmodels import batch as T_batch

PREFILL = [([512, 37, 300], [512, 37, 300]), ([64], [640]), ([9], [9])]
DECODE = [([1] * 6, [64, 900, 4000, 17, 17, 2048]), ([1], [5]), ([1] * 3, [100] * 3)]


def _routing(mod, name):
    if name == "balanced":
        return mod.BalancedRouting()
    return mod.ZipfRouting(alpha=1.1)


def _pair(model, ops, routing="balanced", tp=1, ep=1, pp=1, seed=0, smoke=True,
          **kw):
    def one(configs, hw, op, pred, rt):
        cfg = configs.get_config(model, smoke=smoke)
        h = hw.H100_SXM
        o = op.AnalyticalModels(h) if ops == "analytical" else op.RefinedModels(h)
        return pred.ExecutionPredictor(
            cfg, hw.ParallelismConfig(tp=tp, pp=pp, ep=ep), h, o,
            routing=_routing(rt, routing), seed=seed, memoize=False, **kw)
    return (one(R_configs, R_hw, R_op, R_pred, R_rt),
            one(T_configs, T_hw, T_op, T_pred, T_rt))


@pytest.mark.parametrize("model,routing", [("qwen2-7b", "balanced"),
                                           ("mixtral-8x7b", "balanced"),
                                           ("mixtral-8x7b", "zipf")])
@pytest.mark.parametrize("ops", ["analytical", "refined"])
@pytest.mark.parametrize("smoke", [True, False])
def test_step_time_parts_bit_identical(model, ops, routing, smoke):
    r, t = _pair(model, ops, routing, tp=2, ep=2 if "mixtral" in model else 1,
                 seed=4, smoke=smoke)
    for decode, steps in ((False, PREFILL), (True, DECODE)):
        for q, kv in steps:
            a = r.step_time(q, kv, decode=decode)
            b = t.step_time(q, kv, decode=decode)
            assert a.parts == b.parts
            assert a.total == b.total and a.total > 0
            assert a.moe_straggler_excess == b.moe_straggler_excess
            assert a.dropped_token_frac == b.dropped_token_frac
    # mixed chunked-prefill step
    a = r.step_time([100, 1, 1], [100, 50, 60], decode=False, n_prefill=1)
    b = t.step_time([100, 1, 1], [100, 50, 60], decode=False, n_prefill=1)
    assert a.parts == b.parts


@pytest.mark.parametrize("model,routing", [("qwen2-7b", "balanced"),
                                           ("mixtral-8x7b", "balanced"),
                                           ("mixtral-8x7b", "zipf")])
@pytest.mark.parametrize("decode", [False, True])
def test_numpy_backend_bit_identical(model, routing, decode):
    steps = (DECODE if decode else PREFILL) + [([], [])]
    r, t = _pair(model, "analytical", routing, tp=2,
                 ep=2 if "mixtral" in model else 1, seed=9)
    want = r.step_time_batch(steps, decode=decode, backend="numpy")
    got = t.step_time_batch(steps, decode=decode, backend="numpy")
    np.testing.assert_array_equal(got, want)
    # and equal to the port's own scalar walk, same draws
    _, t2 = _pair(model, "analytical", routing, tp=2,
                  ep=2 if "mixtral" in model else 1, seed=9)
    walk = np.array([t2._step_time_impl(list(q), list(kv), decode=decode).total
                     for q, kv in steps])
    np.testing.assert_array_equal(got, walk)


@pytest.mark.parametrize("model,routing", [("qwen2-7b", "balanced"),
                                           ("mixtral-8x7b", "zipf")])
@pytest.mark.parametrize("decode", [False, True])
def test_fused_backend_close_to_walk_and_to_reference(model, routing, decode):
    steps = (DECODE if decode else PREFILL) + [([], [])]
    ep = 2 if "mixtral" in model else 1
    r, t = _pair(model, "analytical", routing, tp=2, ep=ep, seed=1)
    assert t.device == "cuda"                 # the default; read by "jit" only
    t.device = "cpu"
    got = t.step_time_batch(steps, decode=decode, backend="jit")
    want = r.step_time_batch(steps, decode=decode, backend="jit")
    _, walker = _pair(model, "analytical", routing, tp=2, ep=ep, seed=1)
    walk = np.array([walker._step_time_impl(list(q), list(kv),
                                            decode=decode).total
                     for q, kv in steps])

    def rel(a, b):
        e = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        e[b == 0] = np.abs(a[b == 0])
        return float(e.max())
    # both float32; 1e-5 is the reference's gate for its own fused backend
    assert rel(got, walk) <= 1e-5
    assert rel(got, want) <= 1e-5


def test_price_step_through_backend_keyword():
    cfg = T_configs.get_config("qwen2-7b", smoke=True)
    hw = T_hw.H100_SXM
    mk = lambda **kw: T_pred.ExecutionPredictor(   # noqa: E731
        cfg, T_hw.ParallelismConfig(tp=1), hw, T_op.AnalyticalModels(hw), **kw)
    exact = mk().step_time([64, 32], [64, 32], decode=False).total
    fused = mk(backend="jit", device="cpu").step_time([64, 32], [64, 32],
                                                      decode=False)
    assert list(fused.parts) == ["step"]
    assert abs(fused.total - exact) / exact <= 1e-5
    with pytest.raises(ValueError):
        mk(backend="xla")


def test_moe_routing_draws_consumed_in_the_same_order():
    """The batch path pre-draws routing per (step, layer) in the scalar
    walk's order: after pricing, both packages' generators and both paths'
    generators stand at the same state."""
    steps = PREFILL + [([], [])]
    r, t = _pair("mixtral-8x7b", "analytical", "zipf", tp=2, ep=2, seed=11)
    _, t_walk = _pair("mixtral-8x7b", "analytical", "zipf", tp=2, ep=2, seed=11)
    r.step_time_batch(steps, decode=False, backend="numpy")
    t.step_time_batch(steps, decode=False, backend="numpy")
    for q, kv in steps:
        t_walk._step_time_impl(list(q), list(kv), decode=False)
    s = t.rng.bit_generator.state
    assert s == r.rng.bit_generator.state
    assert s == t_walk.rng.bit_generator.state
    # the pre-drawn rows themselves
    r2, t2 = _pair("mixtral-8x7b", "analytical", "zipf", tp=2, ep=2, seed=11)
    import repro.core.opmodels.batch as R_batch
    want = R_batch._predraw_moe_rows(r2, [849, 64, 9], 2)
    got = T_batch._predraw_moe_rows(t2, [849, 64, 9], 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_routing_modules_draw_the_same_counts():
    assert sorted(T_rt.ROUTERS) == sorted(R_rt.ROUTERS)
    for name in sorted(R_rt.ROUTERS):
        if name == "trace":
            ra = R_rt.resolve_router({"name": name, "fractions": [3, 1, 1, 2]})
            ta = T_rt.resolve_router({"name": name, "fractions": [3, 1, 1, 2]})
        else:
            ra, ta = R_rt.resolve_router(name), T_rt.resolve_router(name)
        a = ra.assign(1000, 4, 2, np.random.default_rng(3))
        b = ta.assign(1000, 4, 2, np.random.default_rng(3))
        np.testing.assert_array_equal(a, b)


def test_calibrated_predictor_takes_the_fitted_branch(tmp_path):
    """The slice as a whole: calibrate -> artifacts -> RefinedModels ->
    predictor, equal to the reference's chain on the same oracle."""
    kw = dict(model="mixtral-8x7b", hardware="H100-SXM", oracle="kernelsim",
              smoke=True, n_train=30, n_eval=8, seed=0)
    R_calib.calibrate(out_root=str(tmp_path / "r"), **kw)
    T_calib.calibrate(out_root=str(tmp_path / "t"), device="cpu", **kw)
    r_cfg = R_configs.get_config("mixtral-8x7b", smoke=True)
    t_cfg = T_configs.get_config("mixtral-8x7b", smoke=True)
    r_ops = R_calib.load_calibrated_ops(str(tmp_path / "r"), r_cfg, R_hw.H100_SXM)
    t_ops = T_calib.load_calibrated_ops(str(tmp_path / "t"), t_cfg, T_hw.H100_SXM)
    r = R_pred.ExecutionPredictor(r_cfg, R_hw.ParallelismConfig(tp=1),
                                  R_hw.H100_SXM, r_ops)
    t = T_pred.ExecutionPredictor(t_cfg, T_hw.ParallelismConfig(tp=1),
                                  T_hw.H100_SXM, t_ops)
    a, b = r.prefill_time([100, 40]), t.prefill_time([100, 40])
    assert a.parts == b.parts and a.total == b.total
    a, b = r.decode_time([100, 40, 7]), t.decode_time([100, 40, 7])
    assert a.parts == b.parts and a.total == b.total
    n_layers = len(t_cfg.pattern)
    window = t_cfg.sliding_window
    own = t_ops.attention.predict([1] * 3, [100, 40, 7], causal=False,
                                  window=window)
    assert b.parts["attn"] == pytest.approx(n_layers * own, rel=1e-12)
