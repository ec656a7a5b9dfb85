"""Spans, device phases and counters of the port's FedAIS round.

Off by default; ``enable()`` turns the whole system on, ``totals()``
returns a snapshot of what it recorded, ``diff(after, before)`` the part
between two snapshots, and ``reset()`` clears it. Three kinds of record:

* **Host spans.** ``with span("fedais.chunk"):`` opens a
  ``torch.profiler.record_function`` range, so the span sits on a
  profiler's timeline (on the device trace's clock, nested under its
  parent), and adds its ``perf_counter_ns`` duration to per-name totals:
  count, total and self time (its duration less its child spans'). A span
  opened with ``device_allocs=True`` adds the change of the caching
  allocator's ``num_device_alloc`` across it to the ``device_allocs``
  counter (the outermost such span only, so nested ones count once); it
  reads the allocator in a child span ``<name>.allocs``.
  Off, ``span`` hands out one shared no-op object: no clock read, no
  range, no allocation. ``span(..., timed=True)`` reads the clock even
  off, for a caller that keeps the duration itself (``.seconds``).
* **Device phases.** ``with device_phase("loss_pass"):`` marks a phase
  on the current stream, inside a phase scope that the executor opens
  around a round (``phase_scope`` over ``new_marks``); outside a scope it
  does nothing. A phase runs from its start to the next phase's start (or
  the scope's end): one stamp a boundary. On CUDA a stamp is a launch of
  the stamp kernel (``kernels/stamp``), which writes the device's global
  timer into a slot of the marks' buffer: under a stream capture it
  becomes a kernel node of the graph. The executor keeps a graph's marks
  and reads them after its own synchronising readback (``read_phases``). A
  replay rewrites the same slots, so what is read is the last replay,
  which the executor multiplies by the key's replays (every replay of a
  key runs the same kernels on the same shapes). On the CPU a stamp is a
  host-clock reading: CPU operations are synchronous, and the accounting
  is the same. Phases do not nest. A phase is the stream's time between
  two boundaries, so it holds any wait of the device inside it (for the
  host's submission of a graph, where the host is the slower). A body run
  the same way every time (the eval) keeps one set of marks
  (``kept_marks``).
* **Counters.** ``count(name, n, key=...)``: replays, eager rounds,
  captures, chunks, rounds, evals; per graph key as ``name[key]``.

Every span the port opens is named ``fedais.*``.
"""
from __future__ import annotations

import time

import torch

__all__ = ["NOOP", "Marks", "count", "device_phase", "diff", "enable", "enabled",
           "kept_marks", "new_marks", "phase_scope", "read_phases", "reset", "span", "totals"]

_ON = False
_SCOPE = None        # the open phase scope, or None
_STACK: list = []    # the open spans, innermost last
_SPANS: dict = {}    # name -> [count, total ns, self ns]
_PHASES: dict = {}   # name -> [count, ms]
_COUNTERS: dict = {}


def enable(on: bool = True) -> None:
    """Switch the spans, phases and counters on (or off)."""
    global _ON
    _ON = bool(on)


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Clear every total and counter."""
    _SPANS.clear()
    _PHASES.clear()
    _COUNTERS.clear()


def totals() -> dict:
    """A snapshot: ``spans`` {name: {count, total_s, self_s}}, ``phases``
    {name: {count, ms}}, ``counters`` {name: n}."""
    return {"spans": {k: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9}
                      for k, (c, t, s) in _SPANS.items()},
            "phases": {k: {"count": c, "ms": ms} for k, (c, ms) in _PHASES.items()},
            "counters": {k if isinstance(k, str) else f"{k[0]}[{_key_name(k[1])}]": n
                         for k, n in _COUNTERS.items()}}


def diff(after: dict, before: dict) -> dict:
    """What ``after`` recorded beyond ``before`` (two ``totals()``); a
    span, phase or counter that recorded nothing between them is left out."""
    def sub(a, b):
        if not isinstance(a, dict):
            return a - b
        out = {k: sub(v, b.get(k, {} if isinstance(v, dict) else 0)) for k, v in a.items()}
        return {k: v for k, v in out.items() if v != 0 and v != {}}
    return {k: sub(after[k], before.get(k, {})) for k in after}


def count(name: str, n: int = 1, key=None) -> None:
    """Add ``n`` to counter ``name`` (and to ``name[key]`` with a key)."""
    if not _ON:
        return
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n
    if key is not None:
        k = (name, key)
        _COUNTERS[k] = _COUNTERS.get(k, 0) + n


def _key_name(key) -> str:
    """A graph key as text: its fields joined by '/', a tuple's by ','."""
    def one(x):
        if isinstance(x, (tuple, list)):
            return ",".join(one(v) for v in x)
        return str(int(x)) if isinstance(x, bool) else str(x)
    return "/".join(one(x) for x in key)


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoOp()


class _Clock:
    """A timed span with the system off: the duration, nothing recorded."""
    __slots__ = ("t0", "ns")

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ns = time.perf_counter_ns() - self.t0
        return False

    @property
    def seconds(self) -> float:
        return self.ns / 1e9


def _device_allocs() -> int:
    if not torch.cuda.is_initialized():
        return 0
    # the nested form: ``memory_stats`` flattens its hundreds of entries in
    # Python on every call, at a chunk's and an eval's start, where the
    # card waits for the host
    return int(torch.cuda.memory_stats_as_nested_dict().get("num_device_alloc", 0))


class _Span(_Clock):
    __slots__ = ("name", "range", "child_ns", "allocs0")

    def __init__(self, name: str, device_allocs: bool):
        self.name = name
        self.allocs0 = -1 if device_allocs else None

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.child_ns = 0
        _STACK.append(self)
        self.t0 = time.perf_counter_ns()
        if self.allocs0 is not None:
            # the outermost counting span counts for those inside it
            counting = any(s.allocs0 is not None for s in _STACK[:-1])
            self.allocs0 = None if counting else self._allocs()
        return self

    def _allocs(self) -> int:
        # a leaf span of its own, so that the read is not this span's self
        # time and a profiler names the host's time in it
        with _Span(self.name + ".allocs", False):
            return _device_allocs()

    def __exit__(self, *exc):
        if self.allocs0 is not None:
            count("device_allocs", self._allocs() - self.allocs0)
        self.ns = ns = time.perf_counter_ns() - self.t0
        _STACK.pop()
        if _STACK:
            _STACK[-1].child_ns += ns
        rec = _SPANS.get(self.name)
        if rec is None:
            rec = _SPANS[self.name] = [0, 0, 0]
        rec[0] += 1
        rec[1] += ns
        rec[2] += ns - self.child_ns
        self.range.__exit__(*exc)
        return False


def span(name: str, *, timed: bool = False, device_allocs: bool = False):
    """A host span (a context manager); see the module's docstring."""
    if not _ON:
        return _Clock() if timed else NOOP
    return _Span(name, device_allocs)


# the boundaries an eager round's marks hold on CUDA; a graph's marks hold
# what its eager round wrote
STAMP_SLOTS = 16384


class Marks:
    """The phase boundaries of one run of a body: the phases' names in the
    order the body opens them, and their stamps (ns). A phase runs from its
    own stamp to the next one, which the next phase's start writes (the
    body opens its phases back to back; what little runs between two of
    them counts in the first) or the scope's end. On CUDA the stamp kernel
    writes the stamps on the device into one buffer of ``slots``, made here
    (so outside any capture); on the CPU they are host-clock readings. A
    run over marks that an earlier run filled writes the same slots again."""
    __slots__ = ("names", "buf", "n", "slots")

    def __init__(self, device: torch.device, slots: int = STAMP_SLOTS):
        self.names: list = []
        self.n = 0           # stamps written by a whole run
        self.slots = slots
        self.buf = (torch.zeros(slots, dtype=torch.int64, device=device)
                    if device.type == "cuda" else [])

    def stamp(self, slot: int) -> None:
        if slot >= self.slots:
            raise RuntimeError(f"more than {self.slots} phase boundaries in one body")
        if isinstance(self.buf, list):
            t = time.perf_counter_ns()
            if slot < len(self.buf):
                self.buf[slot] = t
            else:
                self.buf.append(t)
        else:
            from repro_torch.kernels.stamp.ops import stamp

            stamp(self.buf, slot)

    def times(self) -> list:
        """The stamps (ns), read to the host (waiting for the stream)."""
        if isinstance(self.buf, list):
            return self.buf[:self.n]
        return self.buf[:self.n].tolist()


def new_marks(device, slots: int = STAMP_SLOTS) -> Marks | None:
    """Marks for a run of a body on ``device`` that writes at most ``slots``
    boundaries; None with the system off."""
    return Marks(torch.device(device), slots) if _ON else None


_KEPT: dict = {}     # (name, device) -> the marks kept_marks hands out


def kept_marks(name: str, device, slots: int) -> Marks | None:
    """The marks kept under ``name`` for a body that writes the same
    boundaries on every run (made once; each run writes them again, and
    its reader reads them before the next); None with the system off."""
    if not _ON:
        return None
    key = (name, torch.device(device))
    marks = _KEPT.get(key)
    if marks is None:
        marks = _KEPT[key] = Marks(key[1], slots)
    return marks


class _Scope:
    __slots__ = ("marks", "at", "open", "prev")

    def __init__(self, marks: Marks):
        self.marks, self.at, self.open = marks, 0, False

    def __enter__(self):
        global _SCOPE
        self.prev, _SCOPE = _SCOPE, self
        return self

    def __exit__(self, *exc):
        global _SCOPE
        _SCOPE = self.prev
        if self.open:                # the last phase's end
            self.marks.stamp(self.at)
            self.marks.n = self.at + 1
        return False

    def begin(self, name: str) -> None:
        names = self.marks.names
        if self.at < len(names):
            if names[self.at] != name:
                raise RuntimeError(f"phase {name!r} where the recorded body opened "
                                   f"{names[self.at]!r}")
        else:
            names.append(name)
        self.marks.stamp(self.at)
        self.at += 1
        self.open = False


def phase_scope(marks: Marks | None):
    """Open a phase scope that records into ``marks`` (a no-op for None)."""
    return NOOP if marks is None else _Scope(marks)


class _Phase:
    __slots__ = ("scope", "name")

    def __init__(self, scope: _Scope, name: str):
        self.scope, self.name = scope, name

    def __enter__(self):
        self.scope.begin(self.name)
        return self

    def __exit__(self, *exc):
        self.scope.open = True
        return False


def device_phase(name: str):
    """Mark a device phase's start in the open phase scope (a no-op
    outside one); see ``Marks`` for where it ends."""
    if _SCOPE is None:
        return NOOP
    return _Phase(_SCOPE, name)


def read_phases(marks: Marks | None, times: int = 1) -> None:
    """Add each phase of ``marks`` to the totals, ``times`` over (its
    stamps must have been written). Nothing is read with the system off."""
    if not _ON or marks is None or not marks.n:
        return
    t = marks.times()
    for i, name in enumerate(marks.names):
        rec = _PHASES.get(name)
        if rec is None:
            rec = _PHASES[name] = [0, 0.0]
        rec[0] += times
        rec[1] += times * (t[i + 1] - t[i]) / 1e6
