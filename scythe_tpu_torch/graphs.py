"""The steps between two outputs as replays of one captured step: the port's
counterpart of ``scythe_tpu.model.make_scan``'s ``jax.jit`` of a
``lax.scan``.

On a CUDA state ``scan`` runs the start-up steps eagerly (t = 1 and 2:
Euler / trapezoidal and AB2, branches the host takes on ``state.t``), then
the steady (AB3) step as replays of one CUDA graph of it, captured once for
each step and state layout and kept on the step object.  ``t`` still
advances on the host.

* Capture protocol: the first steady step of a layout is a real step of the
  run, taken eagerly on a side stream (the warm-up: the kernels' nvcc build,
  their plans, the compensated operators' packing and cuBLAS's handles all
  happen there); then a ``torch.cuda.CUDAGraph`` records the next one on a
  stream of its own.
* State buffers: one static buffer per state tensor (spec and the four
  histories).  The graph reads them, runs the step, and copies its new
  state back into them (the spec, the two new histories and the two that
  shift: five copies a step, ordered so that no buffer is overwritten
  before it is read).  One graph and its copies were chosen over a
  ping-pong pair: the histories rotate through three roles, so two graphs
  would still copy, and one graph keeps one private memory pool.
* Aliasing: a chunk copies the caller's state into the buffers and returns
  clones of them, so a state kept from an earlier chunk never changes under
  a later replay (five copies a chunk, not a step).
* Counters: the kernels' launch counts are ``trace.count`` calls in their
  wrappers, which a replay does not run.  What the capture's thread counted
  is held by ``trace.capturing`` (the capture launched nothing) and added
  once a chunk for its replays, so at a chunk's end the counts are the
  launches that ran.
* Tracing (``trace.py``): the span ``graph.capture`` (the warm-up step, the
  capture and the instantiation), the counter ``graph.nodes`` (the
  instantiated graph's nodes) and ``graph.nodes.<stage>``, the nodes each
  stage of the step (``trace.stage``) added to the graph being captured,
  which add up to ``graph.nodes``.  With ``trace.stage_times`` on, the
  stages' timing events inside the graph give the last replay's device
  time of each stage (``stage_seconds``).

The loop stays eager, decided by the inputs and never by a failure: on the
CPU, under ``disable_graphs()`` (the counterpart of ``jax.disable_jit()``),
where grad mode is on and a state tensor requires grad, inside a functorch
transform, for a state that is not tensors, and for a step marked
``capturable = False`` (``parallel.sharding.build_sharded_step``: shards as
threads and collectives).  Any other step that cannot be captured raises
``GraphCaptureError`` naming the line of the op; nothing falls back.

``scan`` takes the capture primitive as a parameter (``CUDA_GRAPH`` on the
card by default), so a test can drive the runner on the CPU with a stub
that replays by calling the captured function again.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
import traceback

import torch

from . import trace
from .device import traced_reason

STARTUP_STEPS = 2  # t = 1 and t = 2 branch on the host t: always eager
_LOCK = threading.Lock()
_disabled = 0
_TORCH = os.path.dirname(torch.__file__)


class GraphCaptureError(RuntimeError):
    """The steady step could not be captured (a host synchronisation, a
    host-to-device copy, or a first-use cost inside the capture)."""


@contextlib.contextmanager
def disable_graphs():
    """Every ``make_scan`` runs its steps eagerly for the duration, in every
    thread: the counterpart of ``jax.disable_jit()``.  Nests."""
    global _disabled
    with _LOCK:
        _disabled += 1
    try:
        yield
    finally:
        with _LOCK:
            _disabled -= 1


def graphs_disabled() -> bool:
    return _disabled > 0


def not_capturable(step):
    """Mark ``step`` as one ``scan`` always runs eagerly; returns it."""
    step.capturable = False
    return step


def eager_reason(step, state) -> str | None:
    """Why ``scan`` runs ``step`` eagerly on ``state`` whatever the device,
    or None."""
    if _disabled:
        return "disable_graphs()"
    if getattr(step, "capturable", True) is False:
        return "the step is marked not capturable"
    tensors = tuple(state[:5])
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        return "the state is not made of tensors"
    return traced_reason(tensors)


@functools.cache
def _libcuda():
    cu = ctypes.CDLL("libcuda.so.1")
    ptr, size = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    cu.cuGraphGetNodes.argtypes = [ptr, ptr, size]
    cu.cuStreamGetCaptureInfo_v2.argtypes = [
        ptr, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ptr), ctypes.POINTER(ptr), size]
    return cu


def _graph_nodes(cu, graph) -> int:
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(graph, None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return n.value


class CudaGraph:
    """The capture primitive on the card."""

    def warm(self, fn, device):
        """``fn()`` on a side stream, then the current stream waits for it."""
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)

    def capture(self, fn, device, buffers):
        """A ``torch.cuda.CUDAGraph`` of ``fn()`` on a stream of its own;
        returns its replay.  Other threads may use the card meanwhile
        (thread_local error mode).  Not ``torch.cuda.graph``: where the
        capture fails, its exit raises before it gives the caller's stream
        back, and the thread would go on on the capture stream, unordered
        against every other thread's work."""
        # keep_graph: the cudaGraph_t stays readable (raw_cuda_graph, to count
        # its nodes); it is then instantiated here, not at the first replay
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        torch.cuda.synchronize(device)
        with torch.cuda.device(device), torch.cuda.stream(torch.cuda.Stream(device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        graph.instantiate()
        return graph.replay

    def nodes_now(self) -> int:
        """Nodes so far of the graph the current stream is capturing into
        (a query the capture allows)."""
        cu = _libcuda()
        status, cid = ctypes.c_int(0), ctypes.c_uint64(0)
        graph, deps, ndeps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t(0)
        err = cu.cuStreamGetCaptureInfo_v2(
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream), ctypes.byref(status),
            ctypes.byref(cid), ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps))
        if err:
            raise RuntimeError(f"cuStreamGetCaptureInfo failed: CUresult {err}")
        return _graph_nodes(cu, graph)

    def graph_nodes(self, replay) -> int:
        """Nodes of the instantiated graph ``replay`` replays."""
        return _graph_nodes(_libcuda(), ctypes.c_void_p(replay.__self__.raw_cuda_graph()))


CUDA_GRAPH = CudaGraph()


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _write_back(buffers, out):
    """Copy the step's new state ``out`` (five tensors) into ``buffers``,
    each buffer written only after every copy that reads it; a slot whose
    output is its own buffer is left alone.  The step's stage ``copies``."""
    with trace.stage("copies"):
        pending = {}
        for k, (buf, src) in enumerate(zip(buffers, out)):
            if src.shape != buf.shape or src.dtype != buf.dtype or src.device != buf.device:
                raise GraphCaptureError(
                    f"the step changes state slot {k} from {buf.dtype} {list(buf.shape)} to "
                    f"{src.dtype} {list(src.shape)} on {src.device}: a captured step must keep "
                    "its state's layout")
            if src.data_ptr() == buf.data_ptr() and src.stride() == buf.stride():
                continue
            pending[k] = src.clone() if _same_storage(src, buf) else src
        while pending:
            free = [k for k in pending
                    if not any(_same_storage(src, buffers[k])
                               for m, src in pending.items() if m != k)]
            if not free:  # a cycle of slots: the readers of one buffer read a copy
                k = next(iter(pending))
                for m, src in pending.items():
                    if m != k and _same_storage(src, buffers[k]):
                        pending[m] = src.clone()
                continue
            for k in free:
                buffers[k].copy_(pending.pop(k))


def _root(exc: BaseException) -> BaseException:
    """The first exception of the chain: the one the capture met, before the
    capture's own end failed because of it."""
    while exc.__cause__ is not None or exc.__context__ is not None:
        exc = exc.__cause__ or exc.__context__
    return exc


def _where(exc: BaseException) -> str:
    """The innermost line outside torch and this module that the exception
    passed through: the op of the step that could not be captured."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(_TORCH) and f.filename != __file__]
    if not frames:
        return "an op inside torch"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


class CapturedStep:
    """One captured steady step of ``step`` on states of one layout: the
    static buffers, the replay, the counts a replay stands for (``counts``),
    and the graph's nodes (``nodes``, None where the capture primitive
    cannot count them) and nodes by stage (``stage_nodes``).  Made by
    ``scan`` from the first steady state it meets, which it advances by one
    (eager, warm-up) step."""

    def __init__(self, step, state, capture):
        device = state.spec.device
        self.buffers = [torch.empty_like(t, memory_format=torch.contiguous_format)
                        for t in state[:5]]
        self.lock = threading.Lock()
        self.replays = 0
        self.load(state)
        t = state.t

        def body():
            out = step(type(state)(*self.buffers, t))
            _write_back(self.buffers, tuple(out[:5]))

        with trace.span("graph.capture"):
            # the warm-up: the first steady step, eagerly, on the card's side stream
            capture.warm(body, device)
            try:
                with trace.capturing(getattr(capture, "nodes_now", None), device) as staged:
                    self.replay = capture.capture(body, device, self.buffers)
            except GraphCaptureError:
                raise
            except Exception as e:  # any failure of the capture names its op
                root = _root(e)
                msg = (str(root).splitlines() or [""])[0]
                raise GraphCaptureError(
                    f"the steady step cannot be captured: {_where(root)}: "
                    f"{type(root).__name__}: {msg}") from e
        self.counts = staged.counts
        count = getattr(capture, "graph_nodes", None)
        self.nodes = count(self.replay) if count else None
        self.stage_nodes = staged.nodes
        self.stage_events = staged.events
        self._timed_replays = 0  # replays whose stage events are not read yet
        if self.nodes is not None:
            trace.count("graph.nodes", self.nodes)
            for name, n in self.stage_nodes.items():
                trace.count(f"graph.nodes.{name}", n)

    def load(self, state):
        for buf, t in zip(self.buffers, state[:5]):
            buf.copy_(t)

    def run(self, n: int):
        for _ in range(n):
            self.replay()
        if n:
            for name, c in self.counts.items():
                trace.count(name, n * c)
        self.replays += n
        if self.stage_events:
            self._timed_replays += n

    def stage_seconds(self) -> dict:
        """{stage: device seconds} of the last replay, if a replay ran since
        the last call and the stages were timed; the replay must be done."""
        if not self._timed_replays:
            return {}
        self._timed_replays = 0
        out = {}
        for name, a, b in self.stage_events:  # a stage's segments, around the stages inside it
            out[name] = out.get(name, 0.0) + 1e-3 * a.elapsed_time(b)
        return out

    def state(self, like, t: int):
        """The buffers' state at step ``t``, in tensors of its own."""
        return type(like)(*(b.clone() for b in self.buffers), t)


def stage_seconds(step) -> dict:
    """{stage: device seconds} of the last replay of each of ``step``'s
    captured steps timed by stage (``CapturedStep.stage_seconds``)."""
    out = {}
    for runner in captured(step).values():
        for name, sec in runner.stage_seconds().items():
            out[name] = out.get(name, 0.0) + sec
    return out


def _key(state):
    return tuple((tuple(t.shape), t.dtype, t.device) for t in state[:5])


def captured(step) -> dict:
    """{state layout: CapturedStep} kept on ``step`` (empty before a run)."""
    return getattr(step, "_captured_steps", None) or {}


def scan(step, n_steps: int, state, capture=None):
    """``n_steps`` steps of ``step`` from ``state`` (see the module
    docstring); ``capture`` is the capture primitive, ``CUDA_GRAPH`` by
    default, where the state is on the card."""
    if n_steps <= 0:
        return state
    eager = eager_reason(step, state) is not None or (
        capture is None and state.spec.device.type != "cuda")
    n = n_steps
    while n and (eager or state.t <= STARTUP_STEPS):
        state = step(state)
        n -= 1
    if not n:
        return state
    t_end = state.t + n
    kept = getattr(step, "_captured_steps", None)
    if kept is None:
        kept = {}
        try:
            step._captured_steps = kept
        except AttributeError:  # a callable without attributes: capture per chunk
            pass
    key = _key(state)
    runner = kept.get(key)
    if runner is None:
        runner = CapturedStep(step, state, capture or CUDA_GRAPH)
        kept[key] = runner
        n -= 1  # its warm-up was this chunk's first steady step
        with runner.lock:
            runner.run(n)
            return runner.state(state, t_end)
    with runner.lock:
        runner.load(state)
        runner.run(n)
        return runner.state(state, t_end)
