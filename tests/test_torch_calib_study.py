"""The oracle's timing and ``repro_torch.calib.study``, the readings behind
C1 and C2 (PERF.md).

On the CPU the ``kernels`` oracle times the plain versions with
``perf_counter``: one warm-up call, then ``reps`` timed ones.  The study's
timings of the CUDA kernels are checked on the card (``gpu`` marker)."""
import math

import numpy as np
import pytest
import torch

from repro_torch.calib import study
from repro_torch.calib.oracle import KernelOracle, KernelSimOracle
from repro_torch.core.hardware import H100_SXM


class Counter:
    def __init__(self):
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1


@pytest.mark.parametrize("reps", [None, 1, 4])
def test_cpu_oracle_times_one_warmup_then_reps(reps):
    orc = KernelOracle(H100_SXM, device="cpu", reps=reps)
    fn = Counter()
    t = orc._time(fn)
    assert orc.reps == (2 if reps is None else reps)      # the CPU's default
    assert fn.calls == 1 + orc.reps          # the warm-up is also the build
    assert t >= 0 and math.isfinite(t)


def test_noisy_kernelsim_scales_each_shape_once():
    plain = KernelSimOracle(H100_SXM)
    a, b = (study.NoisyKernelSim(H100_SXM, study.STUDY_NOISE, seed=k) for k in (1, 2))
    args = ([900, 4000, 128], 32, 8, 128)
    first = a.attention_decode(*args)
    assert a.attention_decode(*args) == first            # kept, not redrawn
    assert b.attention_decode(*args) != first            # each its own draw
    ratio = first / plain.attention_decode(*args)
    assert abs(math.log(ratio)) < 5 * study.STUDY_NOISE
    g = a.grouped_gemm([5, 0, 17, 3], 4096, 14336)
    assert set(k[0] for k in a._cache) == {"decode", "grouped"}
    assert g > 0 and a.limits() == {"max_len": 8192, "max_batch": 64,
                                    "max_tokens": 8192}


def test_attention_regimes_bins_by_kind_split_and_time():
    rnd = KernelOracle(H100_SXM, device="cpu")._round
    rows = [
        # prefill: 10 % off on the events clock, 20 % on the device clock
        {"decode": False, "q_lens": [512], "kv_lens": [512],
         "events": 200e-6, "pred_events": 220e-6,
         "device": 150e-6, "pred_device": 120e-6},
        # decode of one long row: many splits, a fast call
        {"decode": True, "q_lens": [1], "kv_lens": [8000],
         "events": 50e-6, "pred_events": 40e-6,
         "device": 10e-6, "pred_device": 10e-6},
    ]
    got = study.attention_regimes({"eval": rows})
    assert got["all"]["events"]["n"] == 2
    assert got["prefill"]["events"]["mape"] == pytest.approx(0.1)
    assert got["prefill"]["device"]["mape"] == pytest.approx(0.2)
    assert got["decode"]["events"]["mape"] == pytest.approx(0.2)
    from repro_torch.kernels.decode_attention import decode_splits
    splits = decode_splits(1, 8, rnd(8000))
    low = 1 << (splits.bit_length() - 1)
    assert got[f"decode, {low}-{2 * low - 1} splits"]["device"]["mape"] == 0.0
    assert got["true < 20 us"]["device"]["n"] == 1          # the decode's 10 us
    assert got["true 20-100 us"]["events"]["n"] == 1        # the decode's 50 us
    assert got["true > 100 us"]["events"]["n"] == 1
    assert got["true > 100 us"]["device"]["n"] == 1


def test_af_spread_is_relative_to_the_smaller():
    assert study.af_spread([55.02, 65.57]) == pytest.approx((65.57 - 55.02) / 55.02)
    assert study.af_spread([2.0, 2.0]) == 0.0


def test_af_spec_is_the_smoke_scripts_af_deployment():
    spec = study.AF_SPEC
    assert spec["topology"]["preset"] == "af" and spec["model"]["name"] == study.MODEL
    from repro_torch.api import SimSpec
    SimSpec.from_dict(dict(spec, opmodel={"name": "analytical"})).validate()


def test_study_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert study.main(["timing"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_candidates_are_kernel_oracles():
    assert list(study.CANDIDATES)[0] == "events x5"
    for cls in (study.WarmOracle, study.QueuedOracle, study.SpinOracle):
        assert issubclass(cls, KernelOracle) and cls._time is not KernelOracle._time


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernels have no "
                    "interpret mode")
    return "cuda"


@pytest.mark.gpu
def test_candidates_time_a_decode_on_the_card(cuda):
    """Every candidate gives a positive time for the same decode shape; the
    card's time alone (``spin``) is no more than the events' time around
    each call, which adds the host's launch path."""
    got = {name: make().attention_decode([900, 4000, 128, 2048] * 4, 32, 8, 128)
           for name, make in study.CANDIDATES.items()}
    assert all(t > 0 and math.isfinite(t) for t in got.values())
    assert got["spin x10"] <= got["events x5"] * 1.05
    assert np.isfinite(study.device_ms(lambda: torch.ones(8, device=cuda)))
