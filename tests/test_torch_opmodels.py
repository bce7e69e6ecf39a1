"""The port's operator models against the reference's: numpy on both sides,
so every comparison is bit for bit."""
import numpy as np
import pytest

import repro.configs as R_configs
import repro.core.hardware as R_hw
import repro.core.opmodels as R_op
import repro.core.opmodels.calibration as R_cal
import repro.core.opmodels.features as R_feat
import repro_torch.configs as T_configs
import repro_torch.core.hardware as T_hw
import repro_torch.core.opmodels as T_op
import repro_torch.core.opmodels.calibration as T_cal
import repro_torch.core.opmodels.features as T_feat

HW_NAMES = sorted(R_hw.HARDWARE)

ATTN_BATCHES = [
    ([4, 4], [128, 2048], True, 0),
    ([1] * 9, [17, 300, 4096, 64, 64, 900, 12, 1, 2048], False, 0),
    ([512, 37, 2048], [512, 37, 2048], True, 0),
    ([64, 64], [640, 4096], True, 1024),
    ([1, 1, 1], [5000, 100, 4097], False, 4096),
]
GG_BATCHES = [[0, 10, 300], [100] * 8, [2048 - 56] + [8] * 7, [1], [0] * 4,
              [977, 3, 64, 0, 1500, 256, 31, 129]]


def test_hardware_presets_are_equal():
    assert sorted(T_hw.HARDWARE) == HW_NAMES
    for name in HW_NAMES:
        r, t = R_hw.HARDWARE[name], T_hw.HARDWARE[name]
        assert vars(r) == vars(t)


@pytest.mark.parametrize("smoke", [False, True])
def test_model_configs_are_equal(smoke):
    assert sorted(T_configs.REGISTRY) == sorted(R_configs.REGISTRY)
    assert T_configs.ARCH_IDS == R_configs.ARCH_IDS
    for name in R_configs.REGISTRY:
        r = R_configs.get_config(name, smoke=smoke)
        t = T_configs.get_config(name, smoke=smoke)
        assert repr(r) == repr(t)
        assert r.pattern == t.pattern
        assert r.param_count() == t.param_count()
        assert r.padded_vocab == t.padded_vocab


@pytest.mark.parametrize("q,kv,causal,window", ATTN_BATCHES)
def test_attention_features_equal(q, kv, causal, window):
    r = R_feat.attention_features(q, kv, 32, 8, 128, causal=causal, window=window)
    t = T_feat.attention_features(q, kv, 32, 8, 128, causal=causal, window=window)
    np.testing.assert_array_equal(r, t)


@pytest.mark.parametrize("counts", GG_BATCHES)
def test_grouped_gemm_features_equal(counts):
    np.testing.assert_array_equal(
        R_feat.grouped_gemm_features(counts, 4096, 14336),
        T_feat.grouped_gemm_features(counts, 4096, 14336))


def test_random_forest_fit_and_roundtrip_equal():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (300, 5))
    y = np.sin(X[:, 0]) * 3 + X[:, 1] ** 2 + 0.5 * X[:, 2] * X[:, 3]
    r = R_op.RandomForest(n_trees=8, seed=3).fit(X[:250], y[:250])
    t = T_op.RandomForest(n_trees=8, seed=3).fit(X[:250], y[:250])
    np.testing.assert_array_equal(r.predict(X[250:]), t.predict(X[250:]))
    assert r.to_dict() == t.to_dict()
    # each package reads the other's serialized forest
    cross_t = T_op.RandomForest.from_dict(r.to_dict())
    cross_r = R_op.RandomForest.from_dict(t.to_dict())
    np.testing.assert_array_equal(cross_t.predict(X), r.predict(X))
    np.testing.assert_array_equal(cross_r.predict(X), t.predict(X))


@pytest.mark.parametrize("hw", HW_NAMES)
@pytest.mark.parametrize("family", ["kernelsim", "analytical", "vidur_proxy",
                                    "refined"])
def test_operator_model_families_equal(hw, family):
    def build(op, hwmod):
        h = hwmod.HARDWARE[hw]
        if family == "kernelsim":
            return op.VirtualKernels(h)
        if family == "analytical":
            return op.AnalyticalModels(h)
        if family == "vidur_proxy":
            return op.VidurProxyModel(op.VirtualKernels(h))
        return op.RefinedModels(h)
    r, t = build(R_op, R_hw), build(T_op, T_hw)
    for q, kv, causal, window in ATTN_BATCHES:
        if causal:
            a = r.attention_prefill(q, kv, 32, 8, 128, causal=True, window=window)
            b = t.attention_prefill(q, kv, 32, 8, 128, causal=True, window=window)
        else:
            a = r.attention_decode(kv, 32, 8, 128, window=window)
            b = t.attention_decode(kv, 32, 8, 128, window=window)
        assert a == b and a > 0
    for counts in GG_BATCHES:
        assert r.grouped_gemm(counts, 4096, 14336) == \
            t.grouped_gemm(counts, 4096, 14336)
    if family != "vidur_proxy":
        for m, n, k in [(1, 4096, 4096), (777, 14336, 4096), (8192, 128, 512)]:
            assert r.gemm(m, n, k) == t.gemm(m, n, k)
    if family in ("analytical", "refined"):
        assert r.all_reduce(1e6, 4) == t.all_reduce(1e6, 4)
        assert r.all_to_all(1e6, 4) == t.all_to_all(1e6, 4)
        assert r.membound(1e7) == t.membound(1e7)


def test_samplers_draw_the_same_batches():
    r_rng, t_rng = np.random.default_rng(5), np.random.default_rng(5)
    for decode in (False, True) * 6:
        assert R_cal.sample_attention_batch(r_rng, decode=decode, max_len=4096,
                                            max_batch=16) == \
            T_cal.sample_attention_batch(t_rng, decode=decode, max_len=4096,
                                         max_batch=16)
    for _ in range(6):
        kw = dict(n_experts=8, top_k=2, d_in=4096, d_out=14336, max_tokens=8192)
        assert R_cal.sample_grouped_gemm(r_rng, **kw) == \
            T_cal.sample_grouped_gemm(t_rng, **kw)


def test_calibrate_refined_equal():
    kw = dict(n_heads=8, n_kv_heads=2, head_dim=64, moe_dims=(4, 2, 256, 512),
              n_samples=60, seed=1)
    r = R_op.calibrate_refined(R_hw.H100_SXM, **kw)
    t = T_op.calibrate_refined(T_hw.H100_SXM, **kw)
    assert r.attention.forest.to_dict() == t.attention.forest.to_dict()
    assert r.grouped.forest.to_dict() == t.grouped.forest.to_dict()
    assert r.attention_prefill([100, 30], [100, 30], 8, 2, 64) == \
        t.attention_prefill([100, 30], [100, 30], 8, 2, 64)
    assert r.grouped_gemm([10, 0, 99, 7], 256, 512) == \
        t.grouped_gemm([10, 0, 99, 7], 256, 512)


def test_registry_and_resolver_keep_their_names():
    assert sorted(T_op.OPMODELS) == sorted(R_op.OPMODELS)
    hw = T_hw.H100_SXM
    assert type(T_op.resolve_opmodels(None, hw)).__name__ == "OperatorModelSet"
    assert type(T_op.resolve_opmodels("refined", hw)).__name__ == "RefinedModels"
    with pytest.raises(KeyError):
        T_op.resolve_opmodels("nope", hw)


def test_measured_hardware_and_attention_oracle_on_cpu():
    """The two torch probes (the reference times jitted ops here): positive
    rates from the CPU, and an oracle that grows with the work."""
    hw = T_cal.measure_cpu_hardware()
    assert hw.name == "cpu-host" and hw.peak_flops > 0 and hw.hbm_bw > 0
    oracle = T_cal.cpu_attention_oracle(reps=1, device="cpu")
    assert oracle([16], [16], 2, 2, 16) > 0
    assert oracle([16, 32], [16, 32], 2, 2, 16) > 0
