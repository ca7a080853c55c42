"""Serving metrics: named series with rolling percentiles and counters,
a one-line JSON log snapshot, the Prometheus text exposition the HTTP
server's `/metrics?format=prometheus` serves, and a timer feeding a
series (counterpart of `llm_inference_tpu/utils/metrics.py`). The
schedulers observe per-request TTFT and batch tokens/s here."""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import defaultdict
from typing import Dict, List

logger = logging.getLogger("llm_inference_tpu_torch")


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

    def log_snapshot(self) -> None:
        logger.info("metrics %s", json.dumps(self.snapshot(), default=float))

    def prometheus(self, prefix: str = "llmi") -> str:
        """Prometheus text exposition of the snapshot: counters become
        `counter`s, each series' p50, p99 and last value a `gauge` with a
        quantile label; names are cut to the metric charset."""
        def name(n):
            return prefix + "_" + "".join(
                c if c.isalnum() or c == "_" else "_" for c in n)

        with self._lock:
            counters = dict(self._counters)
            series = {k: list(s) for k, s in self._series.items()}
        lines = []
        for k, v in sorted(counters.items()):
            m = name(k)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {float(v)}")
        for k, s in sorted(series.items()):
            if not s:
                continue
            m = name(k)
            lines.append(f"# TYPE {m} gauge")
            srt = sorted(s)
            for q in (50, 99):
                idx = min(len(srt) - 1, int(q / 100.0 * len(srt)))
                lines.append(f'{m}{{quantile="0.{q}"}} {srt[idx]}')
            lines.append(f'{m}{{quantile="last"}} {s[-1]}')
        return "\n".join(lines) + "\n"


class Timer:
    """Context-manager timer feeding a Metrics series (seconds)."""

    def __init__(self, metrics: Metrics, name: str):
        self.metrics, self.name = metrics, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.observe(self.name, time.perf_counter() - self.t0)
        return False
