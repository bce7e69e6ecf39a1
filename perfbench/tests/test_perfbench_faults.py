"""A run with the timed path broken underneath reads ``correct`` false.

Each case drives the whole of a run with one fault planted in the served
engine, for each fault a served cell can have: a decode step that leaves the
slot cache as it was; half of the batch, every other slot's row, replaced by
its neighbour's; a token altered where it is produced (the tokens of every
third position shifted).  A cell on one chip has no exchange between chips to leave
out.  The sound run beside them reads ``correct`` true.

On the CPU, the look for a card skipped, the engine is at its smoke
geometry in float32 under a limit of 1e-3, offered a burst of about ten
requests, more than its four slots hold.  On the card (``gpu``), each cell
of ``BENCHMARK.json`` runs at its own widths, depth, slots and rate for a
short window, judged by its own numbers and limits.
"""
import json
import time

import pytest
import torch

from conftest import ROOT, smoke_cell
from perfbench import harness
from perfbench.spec import load_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
GPU_SECONDS = 4.0


def _state_unchanged(orig):
    def body(self):
        logits, _ = self.model.decode(self.cache, self.tokens, self.pos)
        return logits                       # the new cache never written back
    return body


def _half_the_batch(orig):
    def body(self):
        logits = orig(self)
        out = logits.clone()
        out[1::2] = logits[0::2][:out[1::2].shape[0]]
        return out
    return body


def _token_altered(orig):
    def body(self):
        logits = orig(self)                 # (slots, 1, vocab)
        # every third position's token shifts; decided on the device, since
        # a captured step replays without running this function again
        hit = (self.pos % 3 == 0).view(-1, *[1] * (logits.dim() - 1))
        return torch.where(hit, torch.roll(logits, 1, dims=-1), logits)
    return body


FAULTS = {"sound": None, "state_unchanged": _state_unchanged,
          "half_the_batch": _half_the_batch, "token_altered": _token_altered}


def _plant(fault, monkeypatch):
    from repro_torch.serving.engine import MiniEngine
    if FAULTS[fault] is not None:
        monkeypatch.setattr(MiniEngine, "_decode_body",
                            FAULTS[fault](MiniEngine._decode_body))


@pytest.mark.parametrize("port", ["mixtral-8x7b", "yi-9b"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_reads_incorrect(port, fault, monkeypatch):
    _plant(fault, monkeypatch)
    cell = smoke_cell(port, limit=1e-3, rate=200.0)
    r = harness.run(cell, seed=2 ** 31 + 77, seconds=0.05, trace=False,
                    t0=time.perf_counter(), device="cpu")
    gap = r["checks"]["max_logit_gap"]["value"]
    if fault == "sound":
        assert r["correct"] and gap <= 1e-3
    else:
        assert not r["correct"] and gap > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(set(FAULTS) - {"sound"}))
def test_a_fault_reads_incorrect_at_the_cells_size(name, fault, gpu, monkeypatch):
    _plant(fault, monkeypatch)
    cell = load_cell(name, ROOT)
    r = harness.run(cell, seed=2 ** 31 + 303, seconds=GPU_SECONDS, trace=False,
                    t0=time.perf_counter())
    print(name, fault, json.dumps(r["checks"]))
    assert r["attempted"] >= 2 and not r["correct"]
