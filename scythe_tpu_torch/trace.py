"""The port's one registry of spans and counters.

Tracing is always on, at the granularity of an output boundary and of a
capture: nothing is added to a graph replay, and nothing waits for the card
inside an output interval.

* ``span(name)``: a block of host time.  It opens a
  ``torch.profiler.record_function`` range of that name while a profiler is
  on (``torch.profiler`` / kineto, or ``torch.autograd.profiler.emit_nvtx``
  for nsys), so the block lands on the same timeline as the card's kernels;
  it adds its duration to the registry (count, total, max) and stamps its
  start on the clock the profiler's events use (``time.time_ns``).
* ``count(name, n)``: adds ``n`` to a counter (its total, and the number of
  adds, so a counter has a mean too).  The kernels' wrappers count their
  launches so (``<module>.<counter>``: ``column_solve.launches``,
  ``rlz_analysis.packs``, ``condensation.plain_launches``, ...).  Inside
  ``capturing`` an add on the capturing thread is held on the capture, not
  added: a capture launches nothing, and each replay of the graph stands for
  what the capture held (``graphs.CapturedStep.run`` adds it).
* ``stage(name)``: a stage of the model's step (``model.build_step``;
  ``graphs._write_back`` is ``copies``), or a part of one named on its own
  (``SUBSTAGES``: an equation set's ``hyperdiffusion`` refit inside
  ``tendency``).  On an eager step it is only a profiler range.  Inside
  ``capturing`` (a CUDA graph capture, ``graphs.CapturedStep``) it also
  counts the nodes the stage adds to the graph being captured, and with
  ``stage_times`` on it records timing CUDA events inside the graph, which
  every replay records anew.  Stages nest and count exclusively: a stage
  entered inside another counts its nodes and its time under its own name,
  and the outer stage's count leaves them out, so the counts still add up to
  the graph's nodes.

Every span and counter adds to the process's record (``process()``: the
captures, the kernels' build) and to the open run record: ``model.run_loop``
opens one a call (``run()``), and ``last_run()`` is the latest call's spans
and counters alone.  Adds take one lock: sharded steps run their shards as
threads.  This module imports nothing of the package.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import torch

STAGES = ("synthesis", "tendency", "options", "update", "semiimplicit", "vdiff",
          "condensation", "analysis", "filter", "copies")
# stages entered inside one of STAGES, on the steps that have them
SUBSTAGES = ("hyperdiffusion",)

_LOCK = threading.Lock()
_tls = threading.local()  # .capture: the _Capture of this thread's capture
_stage_times = 0


@dataclass
class Stat:
    """``count`` adds of ``total`` in all, the largest ``max``; a span's
    latest start ``start_ns`` (``time.time_ns``, the profiler's clock)."""

    count: int = 0
    total: float = 0.0
    max: float = 0.0
    start_ns: int | None = None

    def add(self, value, start_ns=None):
        self.count += 1
        self.total += value
        self.max = max(self.max, value)
        if start_ns is not None:
            self.start_ns = start_ns


@dataclass
class Record:
    """Spans (seconds) and counters by name."""

    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    def stat(self, name) -> Stat | None:
        return self.spans.get(name) or self.counters.get(name)

    def total(self, name) -> float | None:
        s = self.stat(name)
        return s.total if s else None

    def mean(self, name) -> float | None:
        s = self.stat(name)
        return s.total / s.count if s and s.count else None

    def copy(self) -> Record:
        return Record({k: Stat(**vars(v)) for k, v in self.spans.items()},
                      {k: Stat(**vars(v)) for k, v in self.counters.items()})


_process = Record()
_run: Record | None = None  # the open run record
_last: Record | None = None  # the latest run record opened


def _add(kind: str, name: str, value, start_ns=None):
    with _LOCK:
        for rec in (_process, _run):
            if rec is not None:
                getattr(rec, kind).setdefault(name, Stat()).add(value, start_ns)


def _profiling() -> bool:
    """Whether a profiler is on: torch.profiler's flag for the process (a
    thread it did not start, such as ``run_loop``'s writer, reads its own
    state as off; a profiler started with ``profile_all_threads`` records
    that thread's ranges, and reads off in every thread), or this thread's
    state."""
    return (getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
            or torch.autograd._profiler_enabled())


class span:
    """``with span(name) as s:`` times the block; ``s.seconds`` after it."""

    __slots__ = ("name", "seconds", "_range", "_t0", "_start_ns")

    def __init__(self, name: str):
        self.name = name
        self.seconds = None

    def __enter__(self):
        self._start_ns = time.time_ns()
        self._t0 = time.perf_counter()
        self._range = torch.profiler.record_function(self.name) if _profiling() else None
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        _add("spans", self.name, self.seconds, self._start_ns)
        return False


def count(name: str, n) -> None:
    cap = getattr(_tls, "capture", None)
    if cap is not None:
        cap.counts[name] = cap.counts.get(name, 0) + n
    else:
        _add("counters", name, n)


@contextlib.contextmanager
def run():
    """The run record of one ``run_loop`` call: spans and counters added
    until the block ends go to it too; ``last_run()`` returns it."""
    global _run, _last
    rec = Record()
    with _LOCK:
        prev, _run, _last = _run, rec, rec
    try:
        yield rec
    finally:
        with _LOCK:
            _run = prev


def last_run() -> Record:
    """The latest ``run_loop`` call's record (empty before the first)."""
    return _last or Record()


def process() -> Record:
    """A copy of the process's record."""
    with _LOCK:
        return _process.copy()


# ---------------------------------------------------------------- stages


@contextlib.contextmanager
def stage_times():
    """Within (in every thread), a captured step's stage markers also record
    timing CUDA events inside the graph (``integrate_model(profile_dir=)``
    turns it on before the capture).  Nests."""
    global _stage_times
    with _LOCK:
        _stage_times += 1
    try:
        yield
    finally:
        with _LOCK:
            _stage_times -= 1


@dataclass
class _Capture:
    nodes_now: object  # () -> nodes so far of the graph being captured, or None
    timed: bool
    nodes: dict = field(default_factory=dict)  # {stage: nodes it added}
    events: list = field(default_factory=list)  # [(stage, start, end)], a stage's segments
    open: list = field(default_factory=list)  # the stages entered and not left, outermost first
    counts: dict = field(default_factory=dict)  # {counter: what the capture's adds held}


@contextlib.contextmanager
def capturing(nodes_now, device):
    """Within, in this thread: the stage markers count the nodes each adds
    (``nodes_now()`` before and after it) and, with ``stage_times`` on and a
    card, record their events; counter adds are held in ``counts``.  Yields
    the ``_Capture``."""
    cap = _Capture(nodes_now, bool(_stage_times) and torch.device(device).type == "cuda")
    prev = getattr(_tls, "capture", None)
    _tls.capture = cap
    try:
        yield cap
    finally:
        _tls.capture = prev


def _event():
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


class stage:
    """``with stage(name):`` marks a stage of the step (see the module
    docstring)."""

    __slots__ = ("name", "_range", "_cap", "_n0", "_inner", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name) if _profiling() else None
        if self._range is not None:
            self._range.__enter__()
        cap = self._cap = getattr(_tls, "capture", None)
        if cap is not None:
            self._n0 = cap.nodes_now() if cap.nodes_now else 0
            self._inner = 0  # nodes of the stages entered inside this one
            self._start = _event() if cap.timed else None
            if cap.open and cap.timed:  # the outer stage's segment ends here
                outer = cap.open[-1]
                cap.events.append((outer.name, outer._start, self._start))
            cap.open.append(self)
        return self

    def __exit__(self, *exc):
        cap = self._cap
        if cap is not None:
            cap.open.pop()
            if exc[0] is None:
                if cap.timed:
                    end = _event()
                    cap.events.append((self.name, self._start, end))
                    if cap.open:  # the outer stage's next segment starts here
                        cap.open[-1]._start = end
                if cap.nodes_now:
                    added = cap.nodes_now() - self._n0
                    cap.nodes[self.name] = cap.nodes.get(self.name, 0) + added - self._inner
                    if cap.open:
                        cap.open[-1]._inner += added
        if self._range is not None:
            self._range.__exit__(*exc)
        return False
