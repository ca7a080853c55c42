"""Serving metrics: named series with rolling percentiles and counters
(counterpart of `llm_inference_tpu/utils/metrics.py`, `Metrics`). The
schedulers observe per-request TTFT and batch tokens/s here."""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List


class Metrics:
    """Thread-safe: serving threads observe and count while readers take
    snapshots."""

    def __init__(self, window: int = 1024):
        self.window = window
        self._lock = threading.Lock()
        self._series: Dict[str, List[float]] = defaultdict(list)
        self._counters: Dict[str, float] = defaultdict(float)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            s = self._series[name]
            s.append(float(value))
            if len(s) > self.window:
                del s[: len(s) - self.window]

    def count(self, name: str, inc: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += inc

    def percentile(self, name: str, p: float) -> float:
        with self._lock:
            s = sorted(self._series.get(name, ()))
        if not s:
            return float("nan")
        idx = min(len(s) - 1, int(p / 100.0 * len(s)))
        return s[idx]

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            series = {k: list(s) for k, s in self._series.items()}
        for name, s in series.items():
            if s:
                out[f"{name}_p50"] = self.percentile(name, 50)
                out[f"{name}_p99"] = self.percentile(name, 99)
                out[f"{name}_last"] = s[-1]
        return out
