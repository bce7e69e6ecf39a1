"""The readers of the engine's own spans (``queue_wait_p95_ms``,
``prefill_stall_share``, ``decode_copyback_share``, ``engine_idle_share``)
on hand-built windows with known answers, nothing from entries without the
keys (a program that records no spans), and a run on the CPU, which records
host spans and no device time."""
import time

import numpy as np
import pytest

from conftest import smoke_cell
from perfbench import harness
from perfbench.harness import Served, Window
from perfbench.spec import load_metric
from perfbench.stats import pct

NEW = ("queue_wait_p95_ms", "prefill_stall_share", "decode_copyback_share",
       "engine_idle_share")


def _window(steps, requests=(), busy_s=1.0):
    return Window(seconds=1.0, busy_s=busy_s, close=10.0, steps=list(steps),
                  requests=list(requests), max_slots=4, shapes={}, device_name="")


def _req(stamps, ok=True):
    n = len(stamps)
    return Served(prompt=np.zeros(4, np.int32), max_new_tokens=n if ok else n + 1,
                  submitted=0.0, tokens=[0] * n, stamps=list(stamps))


def _prefill(start, end, queued=0.0):
    return {"kind": "prefill", "tokens": 4, "dur": end - start, "start": start,
            "end": end, "queued": queued, "device": 0.0, "slot_copy_device": 0.0}


def test_queue_wait_is_the_p95_of_queued_in_ms():
    waits = [0.01, 0.02, 0.05, 0.4, 0.3]
    steps = [_prefill(i, i + 0.5, q) for i, q in enumerate(waits)]
    steps.append({"kind": "decode", "batch": 1, "dur": 0.1})
    got = load_metric("queue_wait_p95_ms").read(_window(steps))
    assert got == pytest.approx(pct([1e3 * q for q in waits], 95))


def test_a_prefill_over_half_a_decode_span_reads_half():
    """Decode from 1.0 to 3.0; its own prefill ends at its first token, and
    another request's prefill covers 1.5 to 2.5: half of it stalled."""
    steps = [_prefill(0.5, 1.0), _prefill(1.5, 2.5)]
    got = load_metric("prefill_stall_share").read(_window(steps, [_req([1.0, 2.0, 3.0])]))
    assert got == pytest.approx(50.0)


def test_the_stall_counts_overlaps_only_and_skips_short_or_unfinished_requests():
    steps = [_prefill(0.2, 1.0), _prefill(2.5, 4.0), _prefill(5.0, 6.0)]
    reqs = [_req([1.0, 3.0]),              # stalled 2.5-3.0 of 2.0 s
            _req([3.5]),                   # one token: no decode span
            _req([0.9, 1.9], ok=False),    # not served to its end
            _req([6.0, 8.0])]              # its own prefill holds 6.0: no stall
    got = load_metric("prefill_stall_share").read(_window(steps, reqs))
    assert got == pytest.approx(100.0 * 0.5 / 4.0)


def test_copyback_share_is_over_the_decode_device_time():
    steps = [{"kind": "decode", "batch": 2, "dur": 0.12, "device": 0.1, "copyback": 0.03},
             {"kind": "decode", "batch": 2, "dur": 0.12, "device": 0.1, "copyback": 0.05},
             _prefill(0.0, 0.5)]
    got = load_metric("decode_copyback_share").read(_window(steps))
    assert got == pytest.approx(40.0)


def test_engine_idle_is_the_busy_time_no_step_ran_on_the_device():
    steps = [{"kind": "decode", "batch": 2, "dur": 0.3, "device": 0.25, "copyback": 0.1},
             {"kind": "decode", "batch": 2, "dur": 0.3, "device": 0.25, "copyback": 0.1},
             dict(_prefill(0.0, 0.3), device=0.2, slot_copy_device=0.05)]
    got = load_metric("engine_idle_share").read(_window(steps, busy_s=1.0))
    assert got == pytest.approx(25.0)


@pytest.mark.parametrize("name", NEW)
def test_entries_without_the_spans_read_nothing(name):
    """The parent program's entries: kind, dur and the step's size only."""
    steps = [{"kind": "prefill", "tokens": 4, "dur": 0.2},
             {"kind": "decode", "batch": 2, "dur": 0.1}]
    assert load_metric(name).read(_window(steps, [_req([1.0, 2.0])])) is None


def test_a_cpu_run_reads_the_host_spans_and_no_device_time():
    cell = smoke_cell("yi-9b", rate=100.0)
    r = harness.run(cell, seed=2 ** 31 + 11, seconds=0.1, trace=True,
                    t0=time.perf_counter(), device="cpu")
    assert r["correct"]
    assert r["metrics"]["queue_wait_p95_ms"]["value"] >= 0.0
    assert 0.0 <= r["metrics"]["prefill_stall_share"]["value"] <= 100.0
    assert "decode_copyback_share" not in r["metrics"]
    assert "engine_idle_share" not in r["metrics"]
