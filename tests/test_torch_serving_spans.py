"""The served engine's own record of its steps (``MiniEngine.step_log``),
on the CPU: each entry's ``dur`` lies inside its ``start`` and ``end``,
steps follow each other on the clock the requests' stamps use; ids are
unique across ``submit`` calls; ``queued`` is the wait from ``submit`` to
the prefill; under a profiler every host phase is one named range a step,
and with none no range is entered.  On the card (``gpu``-marked, skipped
elsewhere): a graphed engine's entries carry the device seconds its
captured events read and the attention kernels' launches (decode's and, in
a prefill, flash attention's), and it serves the eager engine's tokens.  On
the CPU no entry carries either.

This file imports the port only, so it also runs where jax is not installed.
"""
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.serving.engine import MiniEngine

LENGTHS = (12, 20, 7, 16, 30)      # buckets of 16 and 32 tokens
N_NEW = 5
DECODE_PHASES = ("inputs", "replay", "readback", "bookkeeping")
PREFILL_PHASES = ("replay", "inputs", "slot_copy", "readback")  # ``inputs`` inside ``replay``
DEVICE_KEYS = ("device", "copyback", "attn_kernel", "slot_copy_device")
KEYS = {"decode": {"kind", "batch", "dur", "start", "end"},         # on the CPU
        "prefill": {"kind", "tokens", "dur", "start", "end", "queued"}}


def _engine(arch="qwen2-7b", device="cpu", head_dim=None, **kw):
    cfg = get_config(arch, smoke=True)
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    return MiniEngine(cfg, max_slots=2, max_seq=64, seed=0, device=device, **kw)


def _prompts(arch="qwen2-7b", seed=3, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    vocab = get_config(arch, smoke=True).vocab_size
    return [rng.integers(0, vocab, n) for n in lengths]


def _serve_in_two_submits(eng, arch="qwen2-7b"):
    """Two ``submit`` calls and one ``run``: more requests than slots, so
    some wait for a slot."""
    prompts = _prompts(arch)
    reqs = eng.submit(prompts[:3], N_NEW) + eng.submit(prompts[3:], N_NEW - 2)
    eng.run()
    return reqs


@pytest.fixture(scope="module")
def served():
    eng = _engine()
    reqs = _serve_in_two_submits(eng)
    return eng, reqs


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b"])
def test_every_step_lies_inside_its_span(arch):
    eng = _engine(arch)
    _serve_in_two_submits(eng, arch)
    kinds = {s["kind"] for s in eng.step_log}
    assert kinds == {"prefill", "decode"}
    for s in eng.step_log:
        assert 0 < s["dur"] <= s["end"] - s["start"]
        assert set(s) == KEYS[s["kind"]]


def test_steps_follow_each_other_on_one_clock(served):
    eng, reqs = served
    for a, b in zip(eng.step_log, eng.step_log[1:]):
        assert a["end"] <= b["start"]
    first = min(r.submitted for r in reqs)
    assert eng.step_log[0]["start"] >= first


def test_rids_are_unique_across_submits():
    eng = _engine()
    reqs = _serve_in_two_submits(eng)
    assert [r.rid for r in reqs] == list(range(len(LENGTHS)))
    later = eng.submit(_prompts(lengths=(9,)), 2)
    eng.run()
    assert later[0].rid == len(LENGTHS)


def test_queued_is_the_wait_from_submit_to_prefill(served):
    """Admission is first in, first out: the n-th prefill is the n-th
    request submitted."""
    eng, reqs = served
    prefills = [s for s in eng.step_log if s["kind"] == "prefill"]
    assert len(prefills) == len(reqs)
    for s, r in zip(prefills, reqs):
        assert s["queued"] >= 0
        assert s["queued"] == s["start"] - r.submitted
        assert s["tokens"] == len(r.prompt)
    # two slots: the third request waits for a slot that two prefills and
    # a decode step filled and freed
    assert max(s["queued"] for s in prefills) > min(s["queued"] for s in prefills)


def test_a_requests_stamps_lie_inside_the_engines_steps(served):
    """Its first token inside its prefill's span, its end inside the span
    of the decode step that made its last token."""
    eng, reqs = served
    prefills = [s for s in eng.step_log if s["kind"] == "prefill"]
    decodes = [s for s in eng.step_log if s["kind"] == "decode"]
    for s, r in zip(prefills, reqs):
        assert s["start"] <= r.first_token <= s["end"]
        assert sum(d["start"] <= r.finished <= d["end"] for d in decodes) == 1


def test_the_cpu_records_no_device_time(served):
    """Nor a kernel count: no entry, prefill or decode, has ``attn_kernel``."""
    eng, _ = served
    assert {s["kind"] for s in eng.step_log} == {"prefill", "decode"}
    for s in eng.step_log:
        assert not set(DEVICE_KEYS) & set(s)


def test_a_profiler_sees_every_phase_as_a_named_range():
    eng = _engine()
    eng.submit(_prompts(lengths=(12,)), 2)
    eng.run()                            # the bucket's step made before tracing
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve_in_two_submits(eng)
    ranges = [e for e in prof.events() if e.name.startswith("MiniEngine.")]
    names = {e.name for e in ranges}
    # function-scope ranges, which the profiler does not project onto the
    # device's timeline as it does a user's ``record_function``
    assert not any(getattr(e, "is_user_annotation", False) for e in ranges)
    want = ({f"MiniEngine.decode.{p}" for p in DECODE_PHASES}
            | {f"MiniEngine.prefill.{p}" for p in PREFILL_PHASES}
            | {"MiniEngine.submit"})
    assert names == want


def test_each_step_opens_each_of_its_phases_once():
    eng = _engine()
    eng.submit(_prompts(lengths=(12,)), 2)
    eng.run()
    eng.step_log.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve_in_two_submits(eng)
    count = Counter(e.name for e in prof.events() if e.name.startswith("MiniEngine."))
    steps = Counter(s["kind"] for s in eng.step_log)
    for kind, phases in (("decode", DECODE_PHASES), ("prefill", PREFILL_PHASES)):
        for p in phases:
            assert count[f"MiniEngine.{kind}.{p}"] == steps[kind], (kind, p)
    assert count["MiniEngine.submit"] == 2


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range entered with no profiler running")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    eng = _engine()
    reqs = _serve_in_two_submits(eng)
    assert all(len(r.tokens) == r.max_new_tokens for r in reqs)


def test_a_profiler_adds_ranges_not_entries():
    """The same keys either way."""
    eng = _engine()
    _serve_in_two_submits(eng)
    plain = [sorted(s) for s in eng.step_log]
    eng.step_log.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _serve_in_two_submits(eng)
    assert [sorted(s) for s in eng.step_log] == plain


# ------------------------------------------------------------------ card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device seconds come from CUDA "
                    "events captured in the steps' graphs")
    return "cuda"


@pytest.mark.gpu
def test_graphed_entries_carry_device_time_and_serve_the_eager_tokens(cuda):
    out = {}
    for eager in (False, True):
        # head dim 128, the kernel's own: no padding on the donated path
        eng = _engine(device=cuda, head_dim=128, dtype=torch.bfloat16, eager=eager)
        n_attn = sum(k in ("global", "local") for k in eng.model.kinds)
        for _ in range(2):               # the first pass captures each graph
            eng.step_log.clear()
            reqs = _serve_in_two_submits(eng)
        out[eager] = [list(r.tokens) for r in reqs]
        assert eng.graphed is not eager
        for s in eng.step_log:
            device = {"decode": {"device", "copyback", "attn_kernel"},
                      "prefill": {"device", "slot_copy_device", "attn_kernel"}}
            assert set(s) == KEYS[s["kind"]] | device[s["kind"]], s
            assert 0 < s["device"], s
            # the step's attention kernel once per attention layer
            assert s["attn_kernel"] == n_attn > 0, s
            if s["kind"] == "decode":
                # nothing copied back: the cache was written in place
                assert 0 <= s["copyback"] < s["device"] / 10, s
                assert s["device"] <= s["dur"]
            else:
                assert 0 < s["slot_copy_device"], s
    assert out[False] == out[True]
