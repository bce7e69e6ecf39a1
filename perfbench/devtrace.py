"""Readings of the device: NVML's utilisation samples through the window,
and a short ``torch.profiler`` trace after it.

NVML (``libnvidia-ml``, read through ``ctypes``) gives the card's
utilisation: the share of its last sampling period (a sixth of a second to
a second) in which a kernel ran.  Read through the window, it gives the
device's busy share without tracing it: the profiler lengthens a CUDA
graph's replay, so it only runs over a few steps after the window, to name
the device operations that take the time and what the host did in the
gaps.  (NVML's ring of utilisation samples, ``nvmlDeviceGetSamples``, is
not supported on the card's machine.)
"""
from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

TOP = 10                    # entries in each list of the breakdown
LABELLED_GAPS = 400         # longest gaps labelled by the host's activity
NVML_PERIOD_S = 0.1         # how often the utilisation is read
NVML_SETTLE_S = 1.0         # a reading covers up to a second before it
SPAN = "perfbench.profiled_span"    # the host range that marks what is read


class _Util(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


def _nvml_handle(lib, device):
    """NVML's handle of the card ``device`` (a ``torch.device``), looked up
    by the card's UUID, since NVML numbers the host's cards without regard
    to ``CUDA_VISIBLE_DEVICES``; else by torch's own mapping to NVML's
    numbering."""
    import torch
    handle = ctypes.c_void_p()
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    key = (uuid if uuid.startswith("GPU-") else "GPU-" + uuid).encode()
    if lib.nvmlDeviceGetHandleByUUID(ctypes.c_char_p(key), ctypes.byref(handle)) == 0:
        return handle
    try:
        index = torch.cuda._get_nvml_device_index(device)
    except Exception:
        return None
    if lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle)) == 0:
        return handle
    return None


class Nvml:
    """The run's card's utilisation, read every ``NVML_PERIOD_S`` by a thread
    that spends its time asleep or in NVML (which holds no interpreter
    lock); ``None`` from ``open`` where the library or the call is missing."""

    def __init__(self, lib, handle):
        self.lib, self.handle = lib, handle
        self.samples: List[Tuple[float, int]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    @classmethod
    def open(cls, device) -> Optional["Nvml"]:
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return None
        if lib.nvmlInit_v2() != 0:
            return None
        handle, util = _nvml_handle(lib, device), _Util()
        if (handle is None
                or lib.nvmlDeviceGetUtilizationRates(handle, ctypes.byref(util)) != 0):
            return None
        return cls(lib, handle)

    def _poll(self) -> None:
        util = _Util()
        while not self._stop.wait(NVML_PERIOD_S):
            if self.lib.nvmlDeviceGetUtilizationRates(self.handle, ctypes.byref(util)) == 0:
                self.samples.append((time.perf_counter(), int(util.gpu)))

    def start(self) -> "Nvml":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def busy_percent(self, t0: float, t1: float) -> Optional[float]:
        """Mean utilisation read inside [t0 + NVML_SETTLE_S, t1], on
        ``time.perf_counter``'s clock: the readings of the window alone."""
        vals = [v for ts, v in self.samples if t0 + NVML_SETTLE_S <= ts <= t1]
        return float(np.mean(vals)) if vals else None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def breakdown(prof) -> Tuple[float, Dict[str, list]]:
    """(device busy seconds, breakdown) of a finished ``torch.profiler``
    run, inside the host range named ``SPAN`` (the whole trace where there
    is none): the device operations that took most time, and the longest
    idle gaps between them by the innermost host operation running at each
    gap's middle."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    marks = [e.time_range for e in events if e.name == SPAN]
    lo, hi = ((marks[0].start, marks[0].end) if marks
              else (float("-inf"), float("inf")))
    dev, host = [], []
    for e in events:
        if e.name == SPAN or e.time_range.end <= lo or e.time_range.start >= hi:
            continue
        (dev if e.device_type == DeviceType.CUDA else host).append(e)

    def clip(e) -> Tuple[float, float]:
        return max(e.time_range.start, lo), min(e.time_range.end, hi)
    by_name: Dict[str, float] = {}
    for e in dev:
        a, b = clip(e)
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
    busy = _union([clip(e) for e in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:LABELLED_GAPS]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    idle: Dict[str, float] = {}
    for length, a, b in gaps:
        mid = (a + b) / 2
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        label = (host[cover[np.argmax(starts[cover])]].name if cover.size
                 else "host, no traced op")
        idle[label] = idle.get(label, 0.0) + length / 1e6

    def top(d: Dict[str, float]) -> list:
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return busy_s, {"device_ops": top(by_name), "idle_gaps": top(idle)}
