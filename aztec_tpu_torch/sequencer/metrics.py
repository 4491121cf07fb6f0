"""Prometheus-style metrics (ref: falafel/src/metrics/index.ts:9-30).

The reference uses prom-client histograms/gauges/counters (tx received
counts, rollup timers, gas, balances) scraped over HTTP.  Same shape here
with a dependency-free registry + text exposition format (the scrape
surface the reference exposes), so the sequencer/proof servers can mount a
/metrics endpoint.

Port of aztec_tpu/sequencer/metrics.py.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple


class _Metric:
    def __init__(self, name: str, help_: str, mtype: str):
        self.name = name
        self.help = help_
        self.type = mtype
        self.lock = threading.Lock()


class Counter(_Metric):
    def __init__(self, name, help_=""):
        super().__init__(name, help_, "counter")
        self.values: Dict[Tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels):
        key = tuple(sorted(labels.items()))
        with self.lock:
            self.values[key] = self.values.get(key, 0.0) + amount

    def collect(self):
        return [(dict(k), v) for k, v in self.values.items()]


class Gauge(_Metric):
    def __init__(self, name, help_=""):
        super().__init__(name, help_, "gauge")
        self.values: Dict[Tuple, float] = {}

    def set(self, value: float, **labels):
        key = tuple(sorted(labels.items()))
        with self.lock:
            self.values[key] = float(value)

    def collect(self):
        return [(dict(k), v) for k, v in self.values.items()]


class Histogram(_Metric):
    """Cumulative-bucket histogram (prom-client Histogram shape)."""

    DEFAULT_BUCKETS = (0.1, 0.5, 1, 5, 10, 30, 60, 120, 300, 900)

    def __init__(self, name, help_="", buckets=None):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0

    def observe(self, value: float):
        with self.lock:
            self.sum += value
            self.total += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def timer(self):
        """Returns a callable that observes the elapsed time when invoked
        (the reference's `const end = metrics.txRollupTimer(); ...; end()`)."""
        t0 = time.monotonic()
        return lambda: self.observe(time.monotonic() - t0)

    def collect(self):
        out = []
        cum = 0
        for b, c in zip(self.buckets, self.counts[:-1]):
            cum += c
            out.append(({"le": repr(b)}, cum))
        out.append(({"le": "+Inf"}, cum + self.counts[-1]))
        return out


class Metrics:
    """The sequencer's metric set (names mirror falafel's prom metrics)."""

    def __init__(self):
        self._all: List[_Metric] = []

        def reg(m):
            self._all.append(m)
            return m

        self.tx_received = reg(Counter(
            "tx_received_total", "Transactions received, by type"))
        self.tx_settled = reg(Counter(
            "tx_settled_total", "Transactions settled on chain"))
        self.rollup_published = reg(Counter(
            "rollup_published_total", "Rollups published"))
        self.pending_txs = reg(Gauge(
            "pending_txs", "Transactions awaiting rollup"))
        self.tx_rollup_seconds = reg(Histogram(
            "tx_rollup_duration_seconds", "Inner rollup proof time"))
        self.root_rollup_seconds = reg(Histogram(
            "root_rollup_duration_seconds", "Root rollup proof time"))
        self.publish_seconds = reg(Histogram(
            "publish_duration_seconds", "Publish round-trip time"))

    def txReceivedTimer(self):
        return self.tx_rollup_seconds.timer()

    def expose(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        for m in self._all:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.type}")
            for labels, value in m.collect():
                if labels:
                    inner = ",".join(
                        f'{k}="{v}"' for k, v in sorted(labels.items()))
                    lines.append(f"{m.name}{{{inner}}} {value}")
                else:
                    lines.append(f"{m.name} {value}")
            if m.type == "histogram":
                lines.append(f"{m.name}_sum {getattr(m, 'sum', 0.0)}")
                lines.append(f"{m.name}_count {getattr(m, 'total', 0)}")
        return "\n".join(lines) + "\n"
