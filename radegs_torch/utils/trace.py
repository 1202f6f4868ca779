"""The port's tracer: host spans, host syncs, allocator events and counters
per train step and per ``render`` view, kept in memory and reduced when the
run ends (``summary``).

- A **unit** is one train step (``train_step``), one ``render`` view or one
  iteration of ``train()``'s loop. A call is traced when its caller passes
  ``events=`` (the CUDA-event marks' list: the port's trace request). The
  outermost traced entry opens the unit (``unit``); what it calls, with or
  without ``events``, reads the open unit from here. A ``render`` inside a
  traced step opens a ``view`` span of that step, not a unit of its own.
- A **span** (``span``) records its name, its parent span, its unit, its host
  start and end (``time.perf_counter_ns``) and its self time: its duration
  less the time its child spans cover. Spans go to a buffer of ``CAPACITY``;
  later ones are counted as dropped. No span does I/O.
- ``sync(site)`` wraps a read that blocks the host on the device: the unit
  counts the syncs it crossed and the ns they blocked, by site.
- On a card a unit reads the caching allocator's device allocations + frees
  and its allocation retries at its start and end (``torch.cuda``'s
  ``num_device_alloc``, ``num_device_free``, ``num_alloc_retries``).
- **Counters** live in one registry of named groups (``counters``): the
  kernel wrappers' launch counts (``launches.blend``, ``launches.integrate``,
  ``launches.bisect``, the modules' ``LAUNCHES``), ``native.builds`` (nvcc
  builds by library), ``native`` (``build_s``: wall seconds of builds that
  ran nvcc), ``render`` (``pass``: binning-and-blend passes of ``render``'s
  grow loop), ``binning`` (``budget_path``: a card's views whose demand
  passed the instance budget, cut by the kernels at a second sync,
  ``binning.budget``). ``count`` adds to the registry and to the open
  unit.
- **Gauges** are readings of a unit, not events: ``gauge`` sets the open
  unit's ``<group>.<name>`` (the last reading stands), and nothing outside a
  unit. The binning reads ``binning.instances`` (the view's instance demand
  before the budget) and ``binning.budget_cut`` (the instances the budget
  dropped) at its ``binning.total`` sync.
- While a ``torch.profiler`` session records, every span and sync also opens
  ``record_function("radegs::<name>")``: the spans then sit in the
  profiler's Chrome trace as ``user_annotation`` events, on the kernels'
  clock (``idle_by_span`` reads them back), and add no ``cpu_op``.
- Off (no unit open, no profiler), a span or sync site costs the two checks
  and allocates nothing.

``mark`` records the CUDA-event marks of an ``events`` list, as before.
"""

from __future__ import annotations

import statistics
import time

import torch

CAPACITY = 1 << 16  # spans kept, and units kept, before later ones are dropped
PREFIX = "radegs::"  # the profiler annotations' prefix
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # a Chrome trace's device events
OUTSIDE = "(outside any span)"

_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class _Unit:
    __slots__ = ("id", "kind", "t0", "t1", "blocked_ns", "syncs", "sites", "counts",
                 "gauges", "device", "alloc0", "allocs", "retries")

    def __init__(self, uid, kind, device):
        self.id, self.kind, self.device = uid, kind, device
        self.blocked_ns = self.syncs = self.allocs = self.retries = 0
        self.sites: dict = {}
        self.counts: dict = {}
        self.gauges: dict = {}
        self.alloc0 = _alloc_stats(device)


class _State:
    def __init__(self):
        self.unit: _Unit | None = None  # the open unit
        self.stack: list = []  # the open spans of the unit, innermost last
        self.seq = 0  # spans opened in this process
        self.units_opened = 0


_S = _State()
_SPANS: list = []  # (seq, name, parent seq or -1, unit id, t0 ns, t1 ns, self ns)
_UNITS: list = []  # closed _Unit records
_DROPPED = {"spans": 0, "units": 0}
_COUNTERS: dict = {}


def _alloc_stats(device):
    """(device allocations + frees, allocation retries) of the caching
    allocator so far, or None off a card."""
    if device is None or torch.device(device).type != "cuda":
        return None
    s = torch.cuda.memory.memory_stats_as_nested_dict(device)
    return (s.get("num_device_alloc", 0) + s.get("num_device_free", 0),
            s.get("num_alloc_retries", 0))


class _Off:
    """The span or sync of an untraced call: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rf", "seq", "parent", "t0", "child_ns", "on")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.on = _S.unit is not None
        if self.on:
            st = _S.stack
            _S.seq += 1
            self.seq, self.parent, self.child_ns = _S.seq, st[-1].seq if st else -1, 0
            st.append(self)
            self.t0 = _now()
        return self

    def __exit__(self, *exc):
        if self.on:
            t1 = _now()
            st = _S.stack
            st.pop()
            dur = t1 - self.t0
            if st:
                st[-1].child_ns += dur
            if len(_SPANS) < CAPACITY:
                _SPANS.append((self.seq, self.name, self.parent, _S.unit.id, self.t0, t1,
                               dur - self.child_ns))
            else:
                _DROPPED["spans"] += 1
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


class _UnitSpan(_Span):
    __slots__ = ("device",)

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        _S.units_opened += 1
        u = _S.unit = _Unit(_S.units_opened, self.name, self.device)
        _S.stack = []
        super().__enter__()
        u.t0 = self.t0
        return self

    def __exit__(self, *exc):
        u = _S.unit
        super().__exit__(*exc)
        u.t1 = _now()
        a1 = _alloc_stats(u.device)
        if a1 is not None:
            u.allocs, u.retries = a1[0] - u.alloc0[0], a1[1] - u.alloc0[1]
        _S.unit = None
        if len(_UNITS) < CAPACITY:
            _UNITS.append(u)
        else:
            _DROPPED["units"] += 1
        return False


class _Sync:
    __slots__ = ("site", "n", "rf", "t0")

    def __init__(self, site, n):
        self.site, self.n = site, n

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = torch.autograd.profiler.record_function(PREFIX + "sync." + self.site)
            self.rf.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        dt = _now() - self.t0
        u = _S.unit
        if u is not None:
            u.syncs += self.n
            u.blocked_ns += dt
            n, ns = u.sites.get(self.site, (0, 0))
            u.sites[self.site] = (n + self.n, ns + dt)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def unit(kind: str, events, device=None):
    """The span ``kind`` of a traced entry (``step``, ``view``,
    ``iteration``): it opens a unit when the caller passed ``events`` and
    none is open, else it is a plain ``span``. ``device``: where the unit's
    allocator events are read (a CUDA device; None reads none)."""
    if events is not None and _S.unit is None:
        return _UnitSpan(kind, device)
    return span(kind)


def span(name: str):
    """A span ``name`` (a context manager) in the open unit and, under the
    profiler, its ``radegs::`` annotation."""
    if _S.unit is None and not _profiling():
        return _OFF
    return _Span(name)


def sync(site: str, n: int = 1):
    """Wrap code that blocks the host on the device ``n`` times (``int(t)``,
    a boolean index, a copy from pageable host memory): the open unit counts
    them at ``site`` with the ns the block took."""
    if _S.unit is None and not _profiling():
        return _OFF
    return _Sync(site, n)


def sync_node(t, site: str):
    """Count the host sync inside the backward of ``t.grad_fn`` (an autograd
    node that reads the device, such as ``ProdBackward``) at ``site``: hooks
    before and after the node, registered only while a unit is open."""
    node = t.grad_fn
    if _S.unit is None or node is None:
        return
    box = []

    def before(grad_outputs):
        box.append(_Sync(site, 1).__enter__())

    def after(grad_inputs, grad_outputs):
        box.pop().__exit__(None, None, None)

    node.register_prehook(before)
    node.register_hook(after)


def counters(group: str, names=()) -> dict:
    """The registry's dict of counter group ``group``, with ``names`` at 0
    where they are new. The dict is live: code may read and reset it."""
    d = _COUNTERS.setdefault(group, {})
    for n in names:
        d.setdefault(n, 0)
    return d


def count(group: str, name: str, n=1):
    """Add ``n`` to counter ``name`` of ``group``, and to the open unit's
    ``<group>.<name>``."""
    d = _COUNTERS.setdefault(group, {})
    d[name] = d.get(name, 0) + n
    u = _S.unit
    if u is not None:
        key = f"{group}.{name}"
        u.counts[key] = u.counts.get(key, 0) + n


def gauge(group: str, name: str, value):
    """Set the open unit's reading ``<group>.<name>`` to ``value``; a later
    reading in the unit replaces it. Outside a unit it does nothing."""
    u = _S.unit
    if u is not None:
        u.gauges[f"{group}.{name}"] = value


def mark(events: list | None, stage: str):
    """Record a CUDA event after ``stage`` into ``events`` (when given)."""
    if events is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))


def reset():
    """Forget the spans and units traced so far (the counters stay)."""
    _SPANS.clear()
    _UNITS.clear()
    _DROPPED.update(spans=0, units=0)


def spans() -> list:
    """The spans kept: dicts of ``name``, ``parent`` (the parent's ``seq``, -1
    for a unit's root), ``seq``, ``unit``, ``t0_ns``, ``t1_ns``, ``self_ns``,
    in the order they ended."""
    keys = ("seq", "name", "parent", "unit", "t0_ns", "t1_ns", "self_ns")
    return [dict(zip(keys, s)) for s in _SPANS]


def units() -> list:
    """The closed units: dicts of ``id``, ``kind``, ``host_ns``,
    ``blocked_ns``, ``syncs``, ``sites`` ({site: (count, ns)}), ``allocs``,
    ``alloc_retries`` (None off a card), ``counts`` and ``gauges``."""
    return [{"id": u.id, "kind": u.kind, "host_ns": u.t1 - u.t0, "blocked_ns": u.blocked_ns,
             "syncs": u.syncs, "sites": dict(u.sites),
             "allocs": u.allocs if u.alloc0 is not None else None,
             "alloc_retries": u.retries if u.alloc0 is not None else None,
             "counts": dict(u.counts), "gauges": dict(u.gauges)} for u in _UNITS]


def _median(xs):
    return statistics.median(xs) if xs else None


def summary() -> dict:
    """The traced units reduced, by kind of unit (``step``, ``view``,
    ``iteration``): ``units[kind]`` holds ``n`` and the medians per unit of
    ``host_ms`` (the root span), ``blocked_ms`` (inside ``sync``),
    ``dispatch_ms`` (host less blocked), ``syncs``, ``allocs`` and
    ``alloc_retries`` (None off a card), and ``counts`` (each counter's
    median, 0 where a unit lacks it), ``gauges`` (each reading's median over
    the units that read it); ``sites[site]``: the syncs and blocked
    ms over every unit; ``spans[name]``: ``n``, total ``ms`` and ``self_ms``;
    ``counters``: the registry; ``dropped``: spans and units past
    ``CAPACITY``. ``units`` is empty when nothing was traced."""
    by_kind: dict = {}
    for u in units():
        by_kind.setdefault(u["kind"], []).append(u)
    out_units = {}
    sites: dict = {}
    for kind, us in by_kind.items():
        keys = sorted({k for u in us for k in u["counts"]})
        gauges = sorted({k for u in us for k in u["gauges"]})
        on_card = [u for u in us if u["allocs"] is not None]
        out_units[kind] = {
            "n": len(us),
            "host_ms": _median([u["host_ns"] * 1e-6 for u in us]),
            "blocked_ms": _median([u["blocked_ns"] * 1e-6 for u in us]),
            "dispatch_ms": _median([(u["host_ns"] - u["blocked_ns"]) * 1e-6 for u in us]),
            "syncs": _median([u["syncs"] for u in us]),
            "allocs": _median([u["allocs"] for u in on_card]),
            "alloc_retries": _median([u["alloc_retries"] for u in on_card]),
            "counts": {k: _median([u["counts"].get(k, 0) for u in us]) for k in keys},
            "gauges": {k: _median([u["gauges"][k] for u in us if k in u["gauges"]])
                       for k in gauges},
        }
        for u in us:
            for site, (n, ns) in u["sites"].items():
                c = sites.setdefault(site, {"n": 0, "ms": 0.0})
                c["n"] += n
                c["ms"] += ns * 1e-6
    per_span: dict = {}
    for _, name, _, _, t0, t1, self_ns in _SPANS:
        c = per_span.setdefault(name, {"n": 0, "ms": 0.0, "self_ms": 0.0})
        c["n"] += 1
        c["ms"] += (t1 - t0) * 1e-6
        c["self_ms"] += self_ns * 1e-6
    return {"units": out_units, "sites": sites, "spans": per_span,
            "counters": {g: dict(d) for g, d in _COUNTERS.items()}, "dropped": dict(_DROPPED)}


def device_intervals(trace_events) -> list:
    """Sorted (start, end) us of the device's kernels, copies and sets in a
    Chrome trace's events."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in trace_events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)


def device_gaps(iv) -> list:
    """The (start, end) us where none of the sorted intervals ``iv``
    (``device_intervals``) runs, between the first start and the last end."""
    gaps = []
    hi = iv[0][1] if iv else 0.0
    for a, b in iv[1:]:
        if a > hi:
            gaps.append((hi, a))
        hi = max(hi, b)
    return gaps


def idle_by_span(trace_events) -> dict:
    """From a Chrome trace's events: the seconds the device sat idle under
    each innermost ``radegs::`` span (the shortest annotation on any host
    thread running at a gap's middle), largest first; gaps under none go
    to ``OUTSIDE``."""
    ann = [(e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]) for e in trace_events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e.get("name", "").startswith(PREFIX)]
    out: dict = {}
    for a, b in device_gaps(device_intervals(trace_events)):
        t = 0.5 * (a + b)
        best = None
        for ts, te, name in ann:
            if ts <= t <= te and (best is None or te - ts < best[1] - best[0]):
                best = (ts, te, name)
        key = best[2] if best else OUTSIDE
        out[key] = out.get(key, 0.0) + (b - a) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
