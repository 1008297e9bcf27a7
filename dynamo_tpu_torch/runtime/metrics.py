"""Metrics with auto-injected hierarchy labels.

Port of dynamo_tpu/runtime/metrics.py, its `SimpleMetrics` branch:
dict-backed counters, gauges and histograms whose series created through a
runtime / component / endpoint handle carry the dynamo_namespace /
dynamo_component / dynamo_endpoint labels, with a minimal Prometheus
text-exposition `render()`. The machine with the card has no
prometheus_client, so there is no registry-backed branch.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

PREFIX = "dynamo_"
HIERARCHY_LABELS = ("dynamo_namespace", "dynamo_component", "dynamo_endpoint")


class _SimpleValue:
    """One labeled series in the fallback store. Counter/gauge hold a
    float; histogram keeps count/sum (no buckets — the fallback trades
    quantiles for zero dependencies)."""

    __slots__ = ("value", "count", "lock")

    def __init__(self) -> None:
        self.value = 0.0
        self.count = 0
        self.lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self.lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self.lock:
            self.value -= amount

    def set(self, value: float) -> None:
        with self.lock:
            self.value = float(value)

    def observe(self, value: float) -> None:
        with self.lock:
            self.value += float(value)
            self.count += 1


class SimpleMetrics:
    """Dict-backed metrics hierarchy: counter/gauge/histogram series and
    `child(**labels)`, with a minimal Prometheus text-exposition
    `render()`."""

    _KINDS = {"counter": "counter", "gauge": "gauge",
              "histogram": "histogram"}

    def __init__(self, labels: Optional[Dict[str, str]] = None,
                 store: Optional[Dict] = None):
        self.labels = {k: "" for k in HIERARCHY_LABELS}
        self.labels.update(labels or {})
        # (kind, name, label_items) -> _SimpleValue; shared across children
        self._store: Dict[Tuple[str, str, Tuple], _SimpleValue] = (
            store if store is not None else {})

    def child(self, **labels: str) -> "SimpleMetrics":
        merged = dict(self.labels)
        merged.update(labels)
        return SimpleMetrics(labels=merged, store=self._store)

    def _series(self, kind: str, name: str, extra: Dict[str, str]):
        labels = dict(self.labels)
        labels.update({k: str(v) for k, v in extra.items()})
        key = (kind, name, tuple(sorted(labels.items())))
        val = self._store.get(key)
        if val is None:
            val = self._store.setdefault(key, _SimpleValue())
        return val

    def counter(self, name: str, doc: str = "", **extra: str):
        return self._series("counter", name, extra)

    def gauge(self, name: str, doc: str = "", **extra: str):
        return self._series("gauge", name, extra)

    def histogram(self, name: str, doc: str = "", **extra: str):
        return self._series("histogram", name, extra)

    def render(self) -> bytes:
        """Prometheus text exposition from the dict store. Histograms
        expose only _count and _sum series (no buckets)."""
        by_name: Dict[Tuple[str, str], list] = {}
        for (kind, name, label_items), val in sorted(self._store.items()):
            by_name.setdefault((kind, name), []).append((label_items, val))
        lines = []
        for (kind, name), series in by_name.items():
            full = PREFIX + name
            lines.append(f"# TYPE {full} {self._KINDS[kind]}")
            for label_items, val in series:
                lbl = ",".join(
                    f'{k}="{v}"' for k, v in label_items)
                if kind == "histogram":
                    lines.append(f"{full}_count{{{lbl}}} {val.count}")
                    lines.append(f"{full}_sum{{{lbl}}} {val.value}")
                else:
                    lines.append(f"{full}{{{lbl}}} {val.value}")
        return ("\n".join(lines) + "\n").encode() if lines else b""


def make_metrics(namespace: str = "") -> SimpleMetrics:
    return SimpleMetrics(labels={"dynamo_namespace": namespace})
