"""Process-wide metrics registry: Counter/Gauge/Histogram primitives
with Prometheus text exposition and a JSON snapshot API.

Counterpart of ``paddle_tpu/observability/metrics.py``, kept as the port's
own copy (the port imports nothing of ``paddle_tpu``): the same names,
the same exposition bytes and the same snapshot JSON, so the stdlib-only
``tools/metrics_dump.py`` reads either server.  Every instrument is a
host-side, lock-guarded scalar update recorded from values the engine
already holds on the host.  Nothing here touches torch; instrumentation
never launches a kernel or waits on the device.

Design:

* :class:`MetricsRegistry` — thread-safe name -> instrument map.
  Registration is idempotent (re-registering a name returns the
  existing instrument; a *type* mismatch raises loudly).  A default
  process-wide registry backs a bench; engines default to a per-engine
  registry (exact ``/metrics`` scrapes, no cross-engine pollution) and
  can be pointed at the default to aggregate.
* :class:`Counter` — monotonically increasing float.
* :class:`Gauge` — settable float; ``set_function`` installs a
  scrape-time callback so hot paths pay NOTHING to keep it fresh
  (e.g. page-pool utilization is computed only when scraped).
* :class:`Histogram` — fixed upper-bound buckets, cumulative on
  exposition (Prometheus ``le`` semantics), plus ``_sum``/``_count``.

Naming convention: ``paddle_tpu_<subsystem>_<name>_<unit>`` — the
catalogue of docs/OBSERVABILITY.md, unchanged in the port.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "DEFAULT_BUCKETS"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# latency-shaped default: 1ms .. 60s (TTFT on a cold prefill can be
# seconds; a decode step is milliseconds — one set covers both)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _fmt(v: float) -> str:
    """Prometheus number formatting: integral values without the
    trailing ``.0`` (matches the reference exposition style)."""
    if v != v:                                  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonic counter.  ``inc`` with a negative amount raises —
    silent decrements would corrupt every rate() over the series."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}

    def expose(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Gauge:
    """Settable scalar.  ``set_function`` replaces the stored value
    with a scrape-time callback — the preferred form for anything
    derivable from state the owner already keeps (zero hot-path
    cost; a raising callback reads as NaN rather than killing the
    scrape)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._fn = None
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            return float("nan")

    def snapshot(self) -> dict:
        v = self.value
        return {"type": self.kind,
                "value": None if v != v else v}

    def expose(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Histogram:
    """Fixed-bucket histogram (Prometheus cumulative-``le``
    exposition).  Buckets are upper bounds, strictly increasing; the
    implicit ``+Inf`` bucket is always present."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        if not buckets:
            raise ValueError(f"histogram {name} needs >= 1 bucket")
        bs = [float(b) for b in buckets]
        if any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(
                f"histogram {name} buckets must strictly increase")
        self.name = name
        self.help = help
        self.buckets = tuple(bs)
        self._lock = threading.Lock()
        # per-bucket (non-cumulative) counts; last slot is +Inf
        self._counts = [0] * (len(bs) + 1)
        self._sum = 0.0
        self._count = 0
        # EXEMPLARS: the trace ids behind observations ("last" seen
        # and the lifetime "max" value), so a TTFT-p99 spike in the
        # aggregate links straight to the per-request span tree at
        # /trace/<id> (docs/OBSERVABILITY.md, "Tracing")
        self._exemplars: Dict[str, dict] = {}

    def observe(self, value: float, exemplar=None) -> None:
        """Record one observation; ``exemplar`` (a trace id) tags it
        so the JSON snapshot carries a drill-down handle next to the
        aggregate (OpenMetrics-style; the 0.0.4 text exposition is
        unchanged)."""
        v = float(value)
        # bisect by hand: bucket lists are short (<=20) and the call
        # sits on the request path — avoid allocation
        i = 0
        n = len(self.buckets)
        while i < n and v > self.buckets[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                ex = {"value": v, "trace_id": str(exemplar)}
                self._exemplars["last"] = ex
                mx = self._exemplars.get("max")
                if mx is None or v >= mx["value"]:
                    self._exemplars["max"] = ex

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> List[int]:
        """Cumulative counts per bucket, +Inf last (== count)."""
        with self._lock:
            counts = list(self._counts)
        out, run = [], 0
        for c in counts:
            run += c
            out.append(run)
        return out

    def snapshot(self) -> dict:
        cum = self.cumulative()
        out = {"type": self.kind, "count": cum[-1], "sum": self.sum,
               "buckets": {(_fmt(b) if not math.isinf(b) else "+Inf"):
                           c for b, c in
                           zip(list(self.buckets) + [float("inf")],
                               cum)}}
        with self._lock:
            if self._exemplars:
                out["exemplars"] = {k: dict(v) for k, v
                                    in self._exemplars.items()}
        return out

    def expose(self) -> List[str]:
        cum = self.cumulative()
        lines = [f'{self.name}_bucket{{le="{_fmt(b)}"}} {c}'
                 for b, c in zip(self.buckets, cum)]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum[-1]}')
        lines.append(f"{self.name}_sum {_fmt(self.sum)}")
        lines.append(f"{self.name}_count {cum[-1]}")
        return lines


class MetricsRegistry:
    """Thread-safe instrument registry + exposition.

    ``counter``/``gauge``/``histogram`` are get-or-create: the first
    call registers, later calls return the same instrument (so any
    module can name a metric without coordinating construction
    order).  Re-registering a name as a different *type* raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, not {cls.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   buckets=buckets)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-safe {name: {type, value | count/sum/buckets}}."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = []
        for name, m in items:
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            out.extend(m.expose())
        return "\n".join(out) + "\n" if out else ""


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry servers and a bench publish to."""
    return _default
