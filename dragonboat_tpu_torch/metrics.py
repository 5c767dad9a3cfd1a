"""Metrics: counters/gauges with Prometheus-text export.

reference: dragonboat's EnableMetrics wiring (VictoriaMetrics/metrics
counters in nodehost/transport/logdb/raft, exported via
NodeHost.WriteHealthMetrics [U]).  Lock-free-ish: counters use a plain
int guarded by the GIL for add(); export snapshots under a registry
lock.  Disabled registries short-circuit to no-ops so the hot paths pay
one attribute load when metrics are off.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from .logger import get_logger

_log = get_logger("metrics")


def _escape_label_value(v) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline must be escaped or the exposition line is
    malformed (the spec's only three escapes; backslash FIRST so the
    others aren't double-escaped)."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labeled(name: str, labels) -> str:
    """Prometheus-style labelled series name: name{k="v",...}."""
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{_escape_label_value(labels[k])}"' for k in sorted(labels)
    )
    return f"{name}{{{inner}}}"


def _base_name(name: str) -> str:
    return name.split("{", 1)[0]


def _parse_labels(series: str) -> Dict[str, str]:
    """Inverse of :func:`_labeled`: the label dict out of a full series
    name, honoring the three text-format escapes.  Registry keys are
    produced by ``_labeled`` so the walk can assume well-formed
    ``k="v",...`` pairs; anything malformed yields what parsed so far
    (snapshot is observability, never a raise path)."""
    i = series.find("{")
    if i < 0:
        return {}
    out: Dict[str, str] = {}
    s = series[i + 1:series.rfind("}")]
    pos = 0
    while pos < len(s):
        eq = s.find('="', pos)
        if eq < 0:
            break
        key = s[pos:eq]
        val = []
        j = eq + 2
        while j < len(s):
            c = s[j]
            if c == "\\" and j + 1 < len(s):
                nxt = s[j + 1]
                val.append("\n" if nxt == "n" else nxt)
                j += 2
                continue
            if c == '"':
                break
            val.append(c)
            j += 1
        out[key] = "".join(val)
        pos = j + 1
        if pos < len(s) and s[pos] == ",":
            pos += 1
    return out


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "fn", "value", "_warned")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.fn = fn
        self.value = 0.0
        self._warned = False

    def set(self, v: float) -> None:
        self.value = v

    def get(self) -> float:
        if self.fn is None:
            return self.value
        try:
            return float(self.fn())
        except Exception:  # noqa: BLE001 — a callback bug must not
            # poison the whole scrape: export NaN for THIS series and
            # log once per gauge (not once per scrape)
            if not self._warned:
                self._warned = True
                _log.exception("gauge %s callback raised; exporting NaN",
                               self.name)
            return float("nan")


class Histogram:
    """Fixed-bucket latency histogram (seconds).  The default bounds
    suit sub-second request latencies; pass ``bounds`` for series whose
    observations run longer (e.g. multi-second rebalance moves, which
    would otherwise all land in +Inf and carry no distribution)."""

    BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)

    __slots__ = ("name", "bounds", "buckets", "count", "total")

    def __init__(self, name: str, bounds=None):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else self.BOUNDS
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (0 < q <= 1) from the bucket counts:
        the upper bound of the bucket containing the rank.  Overflow
        (+Inf) observations clamp to the last finite bound — callers
        deriving budgets from e.g. ``percentile(0.99)`` should size
        ``bounds`` to their latency regime (a recorded histogram's p99
        makes a ``client.LatencyBudget`` bootstrap when no raw samples
        are at hand)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, b in enumerate(self.bounds):
            acc += self.buckets[i]
            if acc >= rank:
                return b
        return self.bounds[-1]


class _Noop:
    def add(self, n: int = 1) -> None: ...

    def set(self, v: float) -> None: ...

    def observe(self, v: float) -> None: ...


_NOOP = _Noop()


class MetricsRegistry:
    """Per-NodeHost metric registry (one per process is fine too)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None):
        if not self.enabled:
            return _NOOP
        name = _labeled(name, labels)
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(
        self,
        name: str,
        fn: Optional[Callable[[], float]] = None,
        labels: Optional[Dict[str, str]] = None,
    ):
        if not self.enabled:
            return _NOOP
        name = _labeled(name, labels)
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, fn)
            elif fn is not None:
                g.fn = fn
            return g

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  bounds=None):
        if not self.enabled:
            return _NOOP
        name = _labeled(name, labels)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, bounds=bounds)
            return h

    def timer(self, name: str):
        """Context manager recording elapsed seconds into a histogram."""
        hist = self.histogram(name)

        class _T:
            __slots__ = ("t0",)

            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0)
                return False

        return _T()

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Structured, delta-able dump: full series name -> entry with
        parsed base name/labels, the current value and a ``monotone``
        flag (counters and histogram count/sum only ever grow — the
        fleet-scope SLO evaluator deltas exactly those; gauges are
        levels and must be read, not differenced).  Same
        snapshot-under-the-lock / format-outside discipline as
        ``export_text`` (Gauge.get runs user callbacks)."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._hists.values())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for c in counters:
            out["counters"][c.name] = {
                "name": _base_name(c.name),
                "labels": _parse_labels(c.name),
                "value": c.value,
                "monotone": True,
            }
        for g in gauges:
            out["gauges"][g.name] = {
                "name": _base_name(g.name),
                "labels": _parse_labels(g.name),
                "value": g.get(),
                "monotone": False,
            }
        for h in hists:
            out["histograms"][h.name] = {
                "name": _base_name(h.name),
                "labels": _parse_labels(h.name),
                "bounds": list(h.bounds),
                "buckets": list(h.buckets),
                "count": h.count,
                "sum": h.total,
                "monotone": True,
            }
        return out

    def export_text(self) -> str:
        """Prometheus text exposition format."""
        out = []
        typed = set()  # one TYPE line per base name (labelled series share it)

        def type_line(name: str, kind: str) -> None:
            base = _base_name(name)
            if base not in typed:
                typed.add(base)
                out.append(f"# TYPE {base} {kind}")

        # snapshot the instrument lists under the lock, format OUTSIDE
        # it: Gauge.get() runs arbitrary user callbacks that routinely
        # take other locks (NodeHost gauges take _nodes_lock), and
        # calling out of a critical section is a lock-order edge away
        # from a deadlock (raftlint block-under-lock finding; the
        # lockcheck witness graphs exactly this edge).  Value reads are
        # the usual GIL-benign races.
        with self._lock:
            counters = sorted(self._counters.values(), key=lambda x: x.name)
            gauges = sorted(self._gauges.values(), key=lambda x: x.name)
            hists = sorted(self._hists.values(), key=lambda x: x.name)
        for c in counters:
            type_line(c.name, "counter")
            out.append(f"{c.name} {c.value}")
        for g in gauges:
            type_line(g.name, "gauge")
            out.append(f"{g.name} {g.get()}")
        for h in hists:
            type_line(h.name, "histogram")
            base = _base_name(h.name)
            # merge any labels into the bucket brace set: the le
            # label must join the series labels, not follow them
            inner = h.name[len(base):].strip("{}")
            pre = f"{inner}," if inner else ""
            acc = 0
            for i, b in enumerate(h.bounds):
                acc += h.buckets[i]
                out.append(f'{base}_bucket{{{pre}le="{b}"}} {acc}')
            out.append(f'{base}_bucket{{{pre}le="+Inf"}} {h.count}')
            suffix = f"{{{inner}}}" if inner else ""
            out.append(f"{base}_sum{suffix} {h.total}")
            out.append(f"{base}_count{suffix} {h.count}")
        return "\n".join(out) + "\n"


# module-level default used by components not owned by a NodeHost
global_registry = MetricsRegistry(enabled=True)
