"""Readings of the ``kernels`` oracle on the card: how well two fits repeat
(C2) and where the fitted attention error lies (C1).

    PYTHONPATH=src python -m repro_torch.calib.study timing [-o DIR]
    PYTHONPATH=src python -m repro_torch.calib.study c1 [--tree DIR ...] [-o DIR]

``timing`` fits mixtral-8x7b's kernels twice under each of ``CANDIDATES``
(ways of timing one call, each a ``KernelOracle`` subclass), reads the two
fits side by side (``two_fits``) and prices the refined AF deployment
(``AF_SPEC``) from each; then the same for two ``NoisyKernelSim`` oracles,
whose truths differ by timing noise alone.  ``c1`` fits the same kernels on
two clocks (``clock_probe``) and prints the held-out attention error by
regime on each (``attention_regimes``), for this tree and for each
``--tree``: another checkout (say a ``git archive`` unpacked under
``build/``), whose package and kernels run in a process of their own.  Each
prints one JSON line per reading and writes them under ``-o``.  Both need
one CUDA card and ``nvcc`` and take a few minutes; ``chip_smoke.py`` uses
``device_ms`` and ``two_fits`` in its own phases.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

if __name__ == "__main__" and sys.argv[1:2] == ["probe"]:
    # ``study.py probe TREE DIR``, run by path: ``clock_probe`` on TREE's
    # package and kernels (built under TREE/build/)
    sys.path.insert(0, os.path.join(os.path.abspath(sys.argv[2]), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.calib.oracle import KernelOracle, KernelSimOracle  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402

MODEL = "mixtral-8x7b"
# The card's sampling limits (``KernelOracle.limits``) and the sample counts
# that keep ``chip_smoke.py`` inside its time limit.
SIZES = {"n_train": 400, "n_eval": 120, "max_len": 8192, "max_batch": 64}
# chip_smoke.py's AF deployment (phase ``simulate``): full-width
# mixtral-8x7b on the H100 preset, 100 Poisson requests at 10/s.
AF_SPEC = {"name": "af-refined", "model": {"name": MODEL, "smoke": False},
           "topology": {"preset": "af", "n_prefill": 1, "prefill_tp": 2,
                        "n_decode": 1, "m": 4, "ffn_ep": 4,
                        "hardware": "H100-SXM"},
           "workload": {"n_requests": 100, "arrival": "poisson", "rate": 10.0,
                        "prompt_mean": 1024, "output_mean": 128, "seed": 1},
           "pipeline": {"preset": "two_batch", "ep_overlap": 0.5}, "seed": 1}
STUDY_NOISE = 0.005     # about the per-shape repeat spread of ``SpinOracle``


def device_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call that the card takes for ``reps`` calls
    queued back to back, after one warm-up: a spin kernel holds the card
    while the host queues them, so the events around them see the card's
    time and none of the host's launch path.  The spin is doubled until the
    card is still in it when the last call has been queued."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22                          # about 2 ms at the H100's clock
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        caught_up = start.query()             # the card reached the calls first
        torch.cuda.synchronize()
        if not caught_up:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError("device_ms: the host never queued the calls ahead of the card")


class WarmOracle(KernelOracle):
    """The oracle's own timing after ``warmup`` calls instead of one."""

    def __init__(self, hw, warmup: int, **kwargs):
        super().__init__(hw, **kwargs)
        self.warmup = warmup

    def _time(self, fn, *args) -> float:
        for _ in range(self.warmup - 1):
            fn(*args)
        return super()._time(fn, *args)


class QueuedOracle(KernelOracle):
    """One pair of events around ``reps`` calls queued back to back, after
    one warm-up; the mean."""

    def _time(self, fn, *args) -> float:
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(self.reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / self.reps


class SpinOracle(KernelOracle):
    """The card's time alone: ``device_ms`` over ``reps`` calls."""

    def _time(self, fn, *args) -> float:
        return device_ms(lambda: fn(*args), reps=self.reps) * 1e-3


# name: how to make one oracle.  The first is the oracle as ``calibrate``
# makes it (a pair of events around each of 5 calls after one warm-up, the
# median).
CANDIDATES = {
    "events x5": lambda: KernelOracle(H100_SXM),
    "events x20": lambda: KernelOracle(H100_SXM, reps=20),
    "events x5, 20 warm-up calls": lambda: WarmOracle(H100_SXM, warmup=20),
    "queued x10": lambda: QueuedOracle(H100_SXM, reps=10),
    "spin x10": lambda: SpinOracle(H100_SXM, reps=10),
}


class NoisyKernelSim(KernelSimOracle):
    """``kernelsim``'s deterministic times, each shape scaled once by
    exp(N(0, sigma)) from this oracle's own generator, and kept in a
    ``_cache`` keyed by kind as ``KernelOracle``'s is."""

    def __init__(self, hw, sigma: float, seed: int):
        super().__init__(hw)
        self.rng, self.sigma, self._cache = np.random.default_rng(seed), sigma, {}

    def limits(self):
        return {"max_len": 8192, "max_batch": 64, "max_tokens": 8192}  # the card's

    def _noisy(self, key, t: float) -> float:
        if key not in self._cache:
            self._cache[key] = t * math.exp(self.rng.normal(0.0, self.sigma))
        return self._cache[key]

    def attention_prefill(self, q_lens, kv_lens, *args, **kwargs):
        return self._noisy(("prefill", tuple(q_lens), tuple(kv_lens)),
                           super().attention_prefill(q_lens, kv_lens, *args, **kwargs))

    def attention_decode(self, context_lens, *args, **kwargs):
        return self._noisy(("decode", tuple(context_lens)),
                           super().attention_decode(context_lens, *args, **kwargs))

    def grouped_gemm(self, tokens_per_expert, d_in, d_out):
        return self._noisy(("grouped", tuple(tokens_per_expert)),
                           super().grouped_gemm(tokens_per_expert, d_in, d_out))


def fit(oracle, out_root: str):
    from repro_torch.calib import calibrate
    return calibrate(model=MODEL, hardware=H100_SXM.name, oracle=oracle,
                     out_root=out_root, **SIZES)


def two_fits(oracles: list, roots: list) -> dict:
    """Two fits of mixtral-8x7b's kernels side by side: each shape both
    oracles timed, as the median and p90 of |a - b| / b per kind; each
    fit's held-out MAPE on its own truths and on the other oracle's (the
    same held-out grid, every shape cached: no launch); and how far apart
    the two fitted models' predictions are over that grid."""
    from repro_torch.calib import load_calibrated_ops
    from repro_torch.calib.grid import build_grid
    from repro_torch.configs import get_config
    cfg = get_config(MODEL)
    a, b = (o._cache for o in oracles)
    spread = {}
    for kind in ("prefill", "decode", "grouped"):
        rel = np.array([abs(a[k] - b[k]) / b[k] for k in a
                        if k[0] == kind and k in b])
        if rel.size:
            spread[kind] = {"n": int(rel.size), "p50": float(np.median(rel)),
                            "p90": float(np.percentile(rel, 90))}
    grid = build_grid(cfg, seed=0, limits=oracles[0].limits(), **SIZES)
    g, mg = grid.geometry, grid.moe_geometry
    fits = [load_calibrated_ops(root, cfg, H100_SXM) for root in roots]
    scores, preds = {}, {}
    for i, fitted in enumerate(fits, 1):
        preds.setdefault("attention", []).append(np.array([
            fitted.attention.predict(s.q_lens, s.kv_lens, causal=s.causal, window=0)
            for s in grid.attn_eval]))
        preds.setdefault("grouped", []).append(np.array([
            fitted.grouped.predict(s.tokens_per_expert) for s in grid.gg_eval]))
        for j, orc in enumerate(oracles, 1):
            attn = [abs(fitted.attention.predict(s.q_lens, s.kv_lens,
                                                 causal=s.causal, window=0) - t) / t
                    for s in grid.attn_eval
                    for t in [orc.attention(s.q_lens, s.kv_lens, g["n_heads"],
                                            g["n_kv_heads"], g["head_dim"],
                                            causal=s.causal)]]
            gg = [abs(fitted.grouped.predict(s.tokens_per_expert) - t) / t
                  for s in grid.gg_eval
                  for t in [orc.grouped_gemm(s.tokens_per_expert, mg["d_in"],
                                             mg["d_out"])]]
            scores[f"fit {i} on truths {j}"] = {
                "attention_mape": float(np.mean(attn)),
                "grouped_gemm_mape": float(np.mean(gg))}
    apart = {}
    for part, (p1, p2) in preds.items():
        rel = np.abs(p1 - p2) / p2
        apart[part] = {"p50": float(np.median(rel)),
                       "p90": float(np.percentile(rel, 90)), "max": float(rel.max())}
    return {"repeat_spread": spread, "scores": scores, "fits_apart": apart}


def refined_af(calib_root: str) -> float:
    """``AF_SPEC`` priced by the refined models fitted under ``calib_root``:
    its throughput, NaN unless every request completes."""
    from repro_torch.api import SimSpec, run
    spec = dict(AF_SPEC, opmodel={"name": "refined", "calibration": calib_root})
    rep = run(SimSpec.from_dict(spec), device="cuda")
    done = rep.get("n_completed") == AF_SPEC["workload"]["n_requests"]
    return rep.get("throughput_tok_s") if done else float("nan")


def af_spread(tok_s: list) -> float:
    return abs(tok_s[0] - tok_s[1]) / min(tok_s)


def timing_study(out_dir: str) -> list:
    """For each of ``CANDIDATES``, then for two ``NoisyKernelSim`` oracles:
    two fits by two fresh oracles, read by ``two_fits``, and the refined AF
    deployment priced from each fit."""
    lines = []
    noisy = f"kernelsim, {STUDY_NOISE:.1%} noise"
    makers = dict(CANDIDATES)
    makers[noisy] = None
    for name, make in makers.items():
        t0 = time.perf_counter()
        oracles, roots, walls = [], [], []
        for k in (1, 2):
            roots.append(os.path.join(out_dir, name.replace(" ", "_")
                                      .replace(",", ""), str(k)))
            oracles.append(make() if make is not None
                           else NoisyKernelSim(H100_SXM, STUDY_NOISE, seed=k))
            t1 = time.perf_counter()
            fit(oracles[-1], roots[-1])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        line = {"candidate": name, **two_fits(oracles, roots)}
        line["refined_af_tok_s"] = [refined_af(root) for root in roots]
        line["refined_af_spread"] = af_spread(line["refined_af_tok_s"])
        line["calibrate_wall_s"] = walls
        line["wall_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def clock_probe(out_root: str) -> dict:
    """mixtral-8x7b's fit on two clocks over one set of shapes, for the
    tree whose ``repro_torch`` is imported.  Every shape ``calibrate`` asks
    for is timed by the oracle's first clock (a pair of CUDA events around
    each of 5 calls after one warm-up, the median; the host's launch path
    included), written here so that every tree is timed alike, and by
    ``device_ms`` (the card's time alone).  The models are fitted and
    scored on the event times, then refitted and rescored on the device
    times.  Returns each shape's two times and every held-out attention
    sample with its truth and its fitted prediction on each clock."""
    import statistics
    from repro_torch.calib import load_calibrated_ops
    from repro_torch.calib.grid import build_grid
    from repro_torch.configs import get_config

    class TwoClockOracle(KernelOracle):
        def __init__(self, hw):
            super().__init__(hw)
            self.pairs = []

        def _time(self, fn, *args) -> float:
            fn(*args)                                   # warm-up (and the build)
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e-3)
            events_s = statistics.median(times)
            self.pairs.append((events_s, device_ms(lambda: fn(*args), reps=5) * 1e-3))
            return events_s

    cfg = get_config(MODEL)
    orc = TwoClockOracle(H100_SXM)
    roots = {clock: os.path.join(out_root, clock) for clock in ("events", "device")}
    fidelity = {"events": fit(orc, roots["events"]).fidelity}
    measured = list(zip(orc._cache, orc.pairs))
    caches = {"events": {key: ev for key, (ev, _) in measured},
              "device": {key: dv for key, (_, dv) in measured}}
    orc._cache = dict(caches["device"])
    fidelity["device"] = fit(orc, roots["device"]).fidelity      # no launch
    models = {clock: load_calibrated_ops(root, cfg, H100_SXM).attention
              for clock, root in roots.items()}
    grid = build_grid(cfg, seed=0, limits=orc.limits(), **SIZES)
    g = grid.geometry
    samples = []
    for s in grid.attn_eval:
        row = {"decode": s.decode, "q_lens": list(s.q_lens),
               "kv_lens": list(s.kv_lens)}
        for clock, cache in caches.items():
            orc._cache = cache                          # every shape cached: no launch
            row[clock] = orc.attention(s.q_lens, s.kv_lens, g["n_heads"],
                                       g["n_kv_heads"], g["head_dim"],
                                       causal=s.causal)
            row["pred_" + clock] = models[clock].predict(
                s.q_lens, s.kv_lens, causal=s.causal, window=0)
        samples.append(row)
    return {"pairs": [[list(key), ev, dv] for key, (ev, dv) in measured],
            "fidelity": fidelity, "eval": samples}


def shape_clocks(pairs: list) -> dict:
    """Per kind of shape: the oracle's event time over the card's time."""
    shapes = {}
    for kind in ("prefill", "decode", "grouped"):
        ev = np.array([e for key, e, _ in pairs if key[0] == kind])
        dv = np.array([d for key, _, d in pairs if key[0] == kind])
        if not (ev.size and (dv > 0).all()):
            raise RuntimeError(f"clock_probe: no {kind} shape, or a device time of 0")
        ratio = ev / dv
        shapes[kind] = dict(n=int(ev.size),
                            device_ms_p50=float(np.median(dv)) * 1e3,
                            events_minus_device_ms_p50=float(np.median(ev - dv)) * 1e3,
                            events_over_device_p50=float(np.median(ratio)),
                            events_over_device_p90=float(np.percentile(ratio, 90)))
    return shapes


def attention_regimes(probe: dict) -> dict:
    """Held-out error of the fitted attention model by regime, on each
    clock (the fit of that clock against the truths of that clock): prefill
    against decode, decode by its split count in power-of-two bins
    (``decode_splits`` of this tree at the padded length the oracle passes,
    whatever tree ran the kernels), and by the true time."""
    from repro_torch.kernels.decode_attention import decode_splits
    rnd = KernelOracle(H100_SXM, device="cpu")._round
    errs = {}
    for row in probe["eval"]:
        names = ["all"]
        if row["decode"]:
            kv = row["kv_lens"]
            splits = decode_splits(len(kv), 8, rnd(max(kv)))   # mixtral: 8 KV heads
            low = 1 << (splits.bit_length() - 1)
            names += ["decode", f"decode, {low}-{2 * low - 1} splits"]
        else:
            names.append("prefill")
        for clock in ("events", "device"):
            truth = row[clock]
            band = ("true < 20 us" if truth < 20e-6 else
                    "true 20-100 us" if truth <= 100e-6 else "true > 100 us")
            err = abs(row["pred_" + clock] - truth) / truth
            for name in names + [band]:
                errs.setdefault(name, {}).setdefault(clock, []).append(err)
    return {name: {clock: {"n": len(v), "mape": float(np.mean(v)),
                           "p50": float(np.median(v))}
                   for clock, v in by_clock.items()}
            for name, by_clock in sorted(errs.items())}


def other_tree_probe(tree: str, out_dir: str) -> dict:
    """``clock_probe`` on another checkout, in a process of its own."""
    out = os.path.join(out_dir, os.path.basename(tree.rstrip("/")))
    os.makedirs(out, exist_ok=True)
    done = subprocess.run([sys.executable, os.path.abspath(__file__), "probe",
                           tree, out], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=900)
    if done.returncode != 0:
        raise RuntimeError(f"the probe of {tree} exited with "
                           f"{done.returncode}: {done.stdout[-2000:]}")
    with open(os.path.join(out, "probe.json")) as f:
        return json.load(f)


def c1_study(trees: list, out_dir: str) -> list:
    lines = []
    probes = [(".", lambda: clock_probe(os.path.join(out_dir, "this")))]
    probes += [(tree, lambda tree=tree: other_tree_probe(tree, out_dir))
               for tree in trees]
    for tree, probe_of in probes:
        t0 = time.perf_counter()
        probe = probe_of()
        line = {"tree": tree, "wall_s": time.perf_counter() - t0,
                "shapes": shape_clocks(probe["pairs"]),
                "fidelity": probe["fidelity"],
                "attention_by_regime": attention_regimes(probe)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["probe"]:                     # TREE DIR, from other_tree_probe
        tree, out = (os.path.abspath(a) for a in argv[1:3])
        import repro_torch
        if not os.path.abspath(repro_torch.__file__).startswith(tree + os.sep):
            raise SystemExit(f"probe: imported {repro_torch.__file__}, not {tree}'s")
        with open(os.path.join(out, "probe.json"), "w") as f:
            json.dump(clock_probe(out), f)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("study", choices=("timing", "c1"))
    ap.add_argument("--tree", action="append", default=[], metavar="DIR",
                    help="c1: also probe another checkout's package and kernels")
    ap.add_argument("-o", "--out", default=os.path.join("build", "study"),
                    help="directory for the fits and the readings")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("study: no CUDA device; the studies time the kernels on the card",
              file=sys.stderr)
        return 1
    out_dir = os.path.join(args.out, args.study)
    os.makedirs(out_dir, exist_ok=True)
    lines = (timing_study(out_dir) if args.study == "timing"
             else c1_study(args.tree, out_dir))
    with open(os.path.join(out_dir, "readings.json"), "w") as f:
        json.dump(lines, f, indent=1)
    bad = [line["candidate"] for line in lines
           if not all(math.isfinite(t) for t in line.get("refined_af_tok_s", []))]
    if bad:
        print(f"study: the refined AF deployment did not complete for {bad}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
