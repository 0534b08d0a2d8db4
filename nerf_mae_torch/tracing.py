"""Spans and counters inside the port, on exactly while torch.profiler
records.

    with tracing.span("nerf_mae.forward"):
        ...
    y = tracing.mark(y, "nerf_mae.decoder4")   # backward range nerf_mae.decoder4.bwd
    tracing.count("feed.batches")

When no profiler is active a span is one shared no-op context, `mark`
returns its input and `count` does nothing: each costs a read of
torch.autograd.profiler._is_profiler_enabled, a module-level bool. No
record, no CUDA event, no record_function range and no autograd node. The
spans come on with whatever profiles the port: `--profile_dir`
(common.maybe_profile) or `perfbench/`'s traced runs.

While on, a span keeps a Record: its name, its parent (a per-thread
stack), the step it belongs to (the root span's `step`, a TrainState.step,
inherited by its children; on a thread with no open span, the step last
opened), its thread, and its host start and end in ns of time.time_ns(),
the clock torch.profiler converts its events to: a span's interval lands
on a profile's timeline at
`prof.profiler.kineto_results.trace_start_ns() + 1000 * time_range.start`.
On a card (a CUDA context exists) a span also records a start and an end
event on the current stream, from a reused pool; `records()` reads their
device interval once they have completed. A span enters a record_function
range of its own name, so it shows in the profiler's trace beside the
kernels it launched, and the profiler gives the device time under it.

`mark(x, name)` is an identity autograd Function on a model piece's output.
Its backward runs when the backward reaches that output: it ends the
previous piece's `<name>.bwd` record and range and starts its own, so the
marks partition the backward between the pieces (a piece's recomputation is
its own); the backward's last piece ends when the backward does. The
gradient passes through untouched.

`count(name, n)` adds to a dict. `counters()` returns those counts with the
hand-written kernels' `.launches` and a mesh's `collectives` /
`grad_bytes`, read where they live.

Records are capped at MAX_RECORDS; `records()` reads them without
draining and `reset()` clears records and counts. `table(prof)` is the
operator's per-span reading of a profile (common.maybe_profile logs it).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 50_000
ROOT = "nerf_mae.train_step"
BWD = ".bwd"

_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_records: List["Record"] = []
_counts: Dict[str, int] = {}
_free_events: List = []
_origin = None  # the first event of the records, the device clock's zero
_last_step: Optional[int] = None
_open_bwd: Optional["Record"] = None


def on() -> bool:
    """Whether torch.profiler records, so spans, marks and counts do."""
    return _profiler._is_profiler_enabled


class Record:
    """One span (or one piece's backward between two marks). Times: host
    ns of time.time_ns(); device ms from the records' first event, None
    off the card or while the span is open."""

    __slots__ = ("id", "name", "parent", "step", "thread", "start_ns", "end_ns",
                 "device_start_ms", "device_end_ms", "_events", "_range")

    def __init__(self, name: str, parent: Optional[int], step: Optional[int]):
        self.name, self.parent, self.step = name, parent, step
        self.thread = threading.get_native_id()
        self.id = -1
        self.start_ns = self.end_ns = None
        self.device_start_ms = self.device_end_ms = None
        self._events = None
        self._range = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms

    def _open(self, events: bool, at=None) -> None:
        """Start: now, or at `at` = (ns, event), where the previous piece
        ended."""
        if at is None:
            self.start_ns = time.time_ns()
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        if at is not None:
            self.start_ns, ev = at
            self._events = None if ev is None else [ev, None]
        elif events and torch.cuda.is_initialized():
            self._events = [_event(), None]

    def _close(self, handing_over: bool = False):
        """End now; handing over, return (ns, event) for the next piece to
        start at (its range opens after this one's has closed)."""
        if handing_over:
            self._range.__exit__(None, None, None)
            self.end_ns = time.time_ns()
            ev = _event() if self._events is not None else None
        else:
            ev = _event() if self._events is not None else None
            self._range.__exit__(None, None, None)
            self.end_ns = time.time_ns()
        if ev is not None:
            self._events[1] = ev
        self._range = None
        return self.end_ns, ev

    def _resolve(self) -> None:
        if self._events is None or self.end_ns is None or self.device_start_ms is not None:
            return
        start, end = self._events
        end.synchronize()
        self.device_start_ms = _origin.elapsed_time(start)
        self.device_end_ms = _origin.elapsed_time(end)


def _event():
    """A recorded timing event on the current stream, from the pool."""
    global _origin
    with _lock:
        ev = _free_events.pop() if _free_events else None
    if ev is None:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    with _lock:
        if _origin is None:
            _origin = ev
    return ev


def _keep(rec: Record) -> bool:
    with _lock:
        if len(_records) >= MAX_RECORDS:
            return False
        rec.id = len(_records)
        _records.append(rec)
        return True


def _stack() -> List[Record]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "step", "events", "rec")

    def __init__(self, name: str, step: Optional[int], events: bool):
        self.name, self.step, self.events = name, step, events
        self.rec = None

    def __enter__(self):
        global _last_step
        stack = _stack()
        parent = stack[-1] if stack else None
        step = self.step
        if step is None:
            step = parent.step if parent is not None else _last_step
        else:
            _last_step = step
        rec = Record(self.name, None if parent is None else parent.id, step)
        if _keep(rec):
            rec._open(self.events)
            stack.append(rec)
            self.rec = rec
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            _stack().pop()
            rec._close()
        return False


def span(name: str, step: Optional[int] = None, events: bool = True):
    """A context recording `name` while torch.profiler records, else the
    shared no-op. `step` marks a root span (the train step's id);
    `events=False` keeps a span on the host (the feed's worker threads)."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, step, events)


def _end_bwd() -> None:
    """End the open piece's backward record: the backward has ended."""
    global _open_bwd
    rec, _open_bwd = _open_bwd, None
    if rec is not None:
        rec._close()


class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, step):
        ctx.name, ctx.step = name, step
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        global _open_bwd
        if _profiler._is_profiler_enabled:
            prev, _open_bwd = _open_bwd, None
            rec = Record(ctx.name + BWD, None, ctx.step)
            if prev is None:  # the backward's first piece: end the last with it
                torch.autograd.Variable._execution_engine.queue_callback(_end_bwd)
                at = None
            else:  # the previous piece ends where this one starts
                at = prev._close(handing_over=True)
            if _keep(rec):
                rec._open(True, at)
                _open_bwd = rec
        return grad, None, None


def mark(x: torch.Tensor, name: str) -> torch.Tensor:
    """x, through an identity autograd node whose backward starts
    `<name>.bwd`, while on and where x takes a gradient; else x itself."""
    if not (_profiler._is_profiler_enabled and x.requires_grad and torch.is_grad_enabled()):
        return x
    stack = _stack()
    return _Mark.apply(x, name, stack[-1].step if stack else _last_step)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while on."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def counters(mesh=None) -> Dict[str, int]:
    """The counts, the hand-written kernels' launches and, given a mesh,
    its collectives and gradient bytes."""
    from nerf_mae_torch.ops import fused_attention, fused_block
    with _lock:
        out = dict(_counts)
    for fn in (fused_block.fused_swin_block, fused_block.fused_swin_block_bwd,
               fused_attention.fused_window_attention,
               fused_attention.fused_window_attention_bwd):
        out[f"{fn.__name__}.launches"] = fn.launches
    if mesh is not None:
        out["mesh.collectives"] = mesh.collectives
        out["mesh.grad_bytes"] = mesh.grad_bytes
    return out


def records() -> List[Record]:
    """Every closed record so far, oldest first, device times read (each
    card record's end event waited for)."""
    with _lock:
        recs = [r for r in _records if r.end_ns is not None]
    for r in recs:
        r._resolve()
    return recs


def reset() -> None:
    """Clear the records and the counts; their events go back to the pool."""
    global _origin, _last_step, _open_bwd
    with _lock:
        seen = {id(e) for e in _free_events}
        for r in _records:
            for e in r._events or ():
                if e is not None and id(e) not in seen:
                    seen.add(id(e))
                    _free_events.append(e)
        _records.clear()
        _counts.clear()
        _origin = _last_step = _open_bwd = None


def table(prof=None, mesh=None, before: Optional[Dict[str, int]] = None) -> dict:
    """The operator's reading of the spans of a profile: for each name, its
    calls a step (a step is a ROOT record; with none, the totals), host ms,
    self host ms (less its children's), device interval ms, the profiler's
    device busy ms under its range (for the step and the backward, with
    that of the pieces' .bwd ranges, which a card's backward launches
    under on the autograd engine's thread) and the idle ms between them
    (None off the card), then the counters, less `before` (counters() at
    the profile's start)."""
    recs = records()
    steps = sum(r.name == ROOT for r in recs) or 1
    child_ns: Dict[int, int] = {}
    for r in recs:
        if r.parent is not None:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + (r.end_ns - r.start_ns)
    busy: Dict[str, float] = {}
    if prof is not None:
        from torch.autograd import DeviceType
        for e in prof.events():  # host ranges (not their mirrors on the device)
            total = getattr(e, "device_time_total", 0.0)
            if e.device_type == DeviceType.CPU and e.name.startswith("nerf_mae.") and total:
                busy[e.name] = busy.get(e.name, 0.0) + total / 1e3
        # a card's backward launches from the autograd engine's thread, under
        # the pieces' .bwd ranges: theirs is the backward's and the step's
        pieces = sum(v for k, v in busy.items() if k.endswith(BWD))
        for k in (ROOT, "nerf_mae.backward"):
            if k in busy and pieces:
                busy[k] += pieces
    rows: Dict[str, dict] = {}
    for r in recs:
        row = rows.setdefault(r.name, {"calls": 0, "host_ns": 0, "self_ns": 0, "device_ms": None})
        row["calls"] += 1
        row["host_ns"] += r.end_ns - r.start_ns
        row["self_ns"] += r.end_ns - r.start_ns - child_ns.get(r.id, 0)
        if r.device_ms is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + r.device_ms
    out = []
    for name, row in rows.items():
        interval = None if row["device_ms"] is None else row["device_ms"] / steps
        b = busy.get(name)
        b = None if b is None or interval is None else b / steps
        out.append({"span": name, "calls_per_step": row["calls"] / steps,
                    "host_ms": row["host_ns"] / 1e6 / steps,
                    "self_host_ms": row["self_ns"] / 1e6 / steps,
                    "device_interval_ms": interval, "device_busy_ms": b,
                    "idle_ms": None if b is None else interval - b})
    before = before or {}
    return {"steps": steps, "spans": out,
            "counters": {k: v - before.get(k, 0) for k, v in counters(mesh).items()}}


def format_table(t: dict) -> str:
    """table() as aligned text."""
    f = lambda v: "-" if v is None else f"{v:.3f}"
    lines = [f"spans over {t['steps']} step(s), ms a step:",
             f"{'span':34} {'calls':>6} {'host':>9} {'self':>9} {'interval':>9} "
             f"{'busy':>9} {'idle':>9}"]
    for r in t["spans"]:
        lines.append(f"{r['span']:34} {r['calls_per_step']:6.2f} {f(r['host_ms']):>9} "
                     f"{f(r['self_host_ms']):>9} {f(r['device_interval_ms']):>9} "
                     f"{f(r['device_busy_ms']):>9} {f(r['idle_ms']):>9}")
    lines.append("counters: " + ", ".join(f"{k} {v}" for k, v in t["counters"].items()))
    return "\n".join(lines)
