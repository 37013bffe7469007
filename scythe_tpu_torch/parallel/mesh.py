"""Shards and their collectives: the port's counterpart of a one-axis
``jax.sharding.Mesh`` and of the collectives ``jax.shard_map`` gives a body
(``jax.lax.axis_index``, ``psum``, ``ppermute``, ``all_gather``).

A sharded computation is written once, as the body one shard runs (SPMD
form), against the ``Mesh`` interface, and either mesh runs it:

* ``ThreadMesh(n, devices)``: ``n`` shards in this process, one Python
  thread a shard, on one device or several (all ``n`` may share one card);
  the counterpart of the 8 virtual XLA host devices the JAX tests shard
  over.  The shards take turns in rank order, from one collective to the
  next (``ThreadMesh`` says why), and collectives meet in slots; ``psum``
  adds the shards' tensors in rank order, so a run is bitwise repeatable;
  ``ppermute`` and ``all_gather`` hand over references (``.to(device)``
  copies across cards).  Shards on one card share its default stream, so
  the work of every shard is ordered as it was enqueued: a collective,
  which every shard enqueues after its producers, reads finished tensors.
  If a shard raises, every other shard raises at its next wait, and
  ``run`` re-raises the first error; a shard that waits for its turn
  longer than the mesh's timeout fails the run.
* ``DistMesh(group)``: one shard a process over ``torch.distributed``,
  gloo for CPU tensors and NCCL for CUDA tensors (one card a rank,
  ``torchrun``'s layout): ``psum`` is ``all_reduce(SUM)``, ``ppermute``
  ``batch_isend_irecv``, ``all_gather`` ``all_gather_into_tensor`` (NCCL) or
  ``all_gather`` (gloo).  The order of gloo's and NCCL's sums is theirs.

``ppermute(x, pairs)`` takes ``(src, dst)`` pairs as JAX does: a shard no
pair sends to receives zeros, and a pair ``(i, i)`` hands ``x`` back
without communication.

Gradients: both meshes carry a cotangent back to every shard's input,
with the adjoints ``jax.shard_map`` gives: psum's is the psum of the
cotangents, all_gather's each shard's slice of their sum, ppermute's the
reverse permutation.  A ThreadMesh's collectives are differentiable ops on
the shards' shared tensors (a sum, a copy, a stack), so torch.autograd
transposes them itself.  A DistMesh's are ``torch.autograd.Function``s
whose backward issues the adjoint collective over torch.distributed
(``_PsumFn``, ``_PpermuteFn``, ``_AllGatherFn``).  The cotangent a rank
holds of a replicated value is its share, as in JAX: the whole cotangent
is the sum over ranks (``parallel.sharding.replicated_grad`` seeds a
replicated cost and sums a replicated input's gradient so).  Every rank
runs the same body, so its graph and the order in which autograd reaches
the collectives' backwards are every rank's; a collective's backward runs
on every rank of the group or on none.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Sequence

import torch

from ..device import DEFAULT, resolve_device

# seconds a ThreadMesh shard waits for its turn before the run fails
TURN_TIMEOUT = 300.0


class Mesh:
    """The interface a sharded body is written against.  ``size`` shards,
    ranks 0..size-1; ``local_ranks`` are those this process runs, and
    ``run(fn, *per_shard_args)`` runs ``fn`` on each of them, the i-th entry
    of every argument list going to ``local_ranks[i]``, and returns their
    results in that order.  Inside ``fn``, ``index`` and ``device`` are the
    calling shard's, and the collectives pair it with every other shard."""

    size: int
    local_ranks: tuple[int, ...]

    def device_of(self, rank: int) -> torch.device:
        raise NotImplementedError

    @property
    def index(self) -> int:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.device_of(self.index)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def ppermute(self, x: torch.Tensor, pairs: Sequence[tuple[int, int]]) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` stacked along a new axis 0, in rank order."""
        raise NotImplementedError

    def run(self, fn: Callable, *per_shard_args: Sequence) -> list:
        raise NotImplementedError

    def gather(self, parts: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
        """The whole tensor whose local shards are ``parts``, cut along
        ``axis``: concatenated in rank order (called outside ``run``)."""
        raise NotImplementedError


def _check_pairs(pairs, n: int) -> dict[int, int]:
    """dst -> src of a permutation's pairs (each rank sends and receives at
    most once), as jax.lax.ppermute requires."""
    srcs, by_dst = set(), {}
    for s, d in pairs:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"ppermute pair {(s, d)} outside ranks 0..{n - 1}")
        if s in srcs or d in by_dst:
            raise ValueError(f"ppermute pairs {list(pairs)} are not a permutation")
        srcs.add(s)
        by_dst[d] = s
    return by_dst


class ShardAborted(RuntimeError):
    """Raised in a shard when another shard failed, or when it waited for
    its turn longer than the mesh's timeout."""


class ThreadMesh(Mesh):
    """``n`` shards in this process, one thread a shard.  ``devices``: one
    device for all shards or a sequence of ``n``.  ``timeout``: seconds a
    shard waits for its turn before the run fails.

    The shards take turns: one thread runs at a time, from one collective
    to its next, posts its value in its slot and hands the turn to the next
    shard in rank order; when the turn comes back, every shard has posted,
    and it reads the slots.  Every launch goes through the one interpreter
    lock anyway, and threads that each hold it for a launch and then wait
    for it again spend their time handing it over; a thread waiting for
    its turn wants no lock.  The slots of two successive collectives
    alternate, so a shard posting its next value overwrites none that
    another shard has still to read."""

    def __init__(self, n: int, devices: Any, timeout: float = TURN_TIMEOUT):
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        if isinstance(devices, (str, torch.device)):
            devices = [devices] * n
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} shards")
        self.size = n
        self.local_ranks = tuple(range(n))
        self.devices = tuple(resolve_device(d) for d in devices)
        self.timeout = timeout
        self._cv = threading.Condition()  # guards the turn, done and failed
        self._reset()
        self._local = threading.local()
        self._run_lock = threading.Lock()  # one run of a mesh at a time

    def _reset(self):
        n = self.size
        self._slots = ([None] * n, [None] * n)
        self._calls = [0] * n  # collectives each shard has entered this run
        self._turn = 0  # the shard that runs
        self._done = [False] * n  # shards whose body has returned
        self._failed = False

    def __repr__(self):
        return f"ThreadMesh({self.size}, {[str(d) for d in self.devices]})"

    def device_of(self, rank: int) -> torch.device:
        return self.devices[rank]

    @property
    def index(self) -> int:
        rank = getattr(self._local, "rank", None)
        if rank is None:
            raise RuntimeError("a ThreadMesh collective runs only inside ThreadMesh.run")
        return rank

    def _pass_turn(self, r: int):
        """The turn to the next shard after ``r`` whose body still runs
        (``r`` itself if none); the caller holds ``_cv``."""
        n = self.size
        self._turn = next((q for q in ((r + k) % n for k in range(1, n + 1))
                           if not self._done[q]), r)
        self._cv.notify_all()

    def _await_turn(self, r: int):
        """Wait until it is shard ``r``'s turn; the caller holds ``_cv``."""
        ok = self._cv.wait_for(lambda: self._turn == r or self._failed, self.timeout)
        if self._failed:
            raise ShardAborted(f"shard {r}: another shard failed")
        if not ok:
            self._fail()
            raise ShardAborted(f"shard {r} waited more than {self.timeout} s for its turn")

    def _fail(self):
        self._failed = True
        self._cv.notify_all()

    def _exchange(self, x: torch.Tensor) -> list:
        """Post ``x`` in this shard's slot, let every other shard post its
        own, and return the slots."""
        r = self.index
        c = self._calls[r]
        slots = self._slots[c % 2]
        slots[r] = x
        self._calls[r] = c + 1
        with self._cv:
            self._pass_turn(r)
            self._await_turn(r)
            if min(self._calls) <= c:
                self._fail()
                raise RuntimeError(f"shard {r} is at collective {c}, which a shard whose "
                                   "body returned never reached")
        return slots

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        slots = self._exchange(x)
        out = slots[0].to(x.device)
        for s in slots[1:]:
            out = out + s.to(x.device)
        return out

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        src = _check_pairs(pairs, self.size).get(self.index)
        slots = self._exchange(x)
        if src is None:
            return torch.zeros_like(x)
        return slots[src].to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        slots = self._exchange(x)
        return torch.stack([s.to(x.device) for s in slots])

    def run(self, fn: Callable, *per_shard_args: Sequence) -> list:
        n = self.size
        for a in per_shard_args:
            if len(a) != n:
                raise ValueError(f"run takes one argument a shard: {len(a)} for {n}")
        results: list = [None] * n
        errors: list = []
        # grad mode is thread-local: each shard runs under the caller's
        grad = torch.is_grad_enabled()

        def shard(r):
            self._local.rank = r
            try:
                with self._cv:
                    self._await_turn(r)
                dev = self.devices[r]
                with torch.set_grad_enabled(grad), (
                        torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()):
                    results[r] = fn(*(a[r] for a in per_shard_args))
            except BaseException as e:  # handed to the caller by run
                errors.append(e)
                with self._cv:
                    self._fail()
            else:
                with self._cv:
                    self._done[r] = True
                    self._pass_turn(r)
            finally:
                self._local.rank = None

        with self._run_lock:
            self._reset()
            threads = [threading.Thread(target=shard, args=(r,), name=f"shard-{r}",
                                        daemon=True) for r in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            self._reset()  # hold no shard's tensor
            if errors:
                raise next((e for e in errors if not isinstance(e, ShardAborted)), errors[0])
        return results

    def gather(self, parts, axis: int) -> torch.Tensor:
        dev = parts[0].device
        return torch.cat([p.to(dev) for p in parts], dim=axis)


class _PsumFn(torch.autograd.Function):
    """``all_reduce(SUM)`` of ``x`` over the mesh's group; its adjoint is
    the ``all_reduce(SUM)`` of the cotangents."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.set_materialize_grads(True)  # a rank whose output got no cotangent still joins
        return mesh._all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_reduce(g), None


class _PpermuteFn(torch.autograd.Function):
    """``x`` sent along the ``(src, dst)`` pairs; its adjoint sends each
    rank's cotangent back along the reversed pairs: a rank that received
    sends its cotangent to its source, a rank that sent receives its input's
    cotangent from its destination, and one that sent nothing gets zeros."""

    @staticmethod
    def forward(ctx, x, mesh, pairs):
        ctx.mesh = mesh
        ctx.pairs = [(d, s) for s, d in pairs]
        ctx.set_materialize_grads(True)
        return mesh._ppermute(x, pairs)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._ppermute(g, ctx.pairs), None, None


class _AllGatherFn(torch.autograd.Function):
    """Every rank's ``x`` stacked along a new axis 0; its adjoint is this
    rank's slice of the cotangents summed over ranks (``reduce_scatter``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.set_materialize_grads(True)
        return mesh._all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._reduce_scatter(g), None


class DistMesh(Mesh):
    """One shard a process of a ``torch.distributed`` group (the default
    group unless one is given); its rank in the group is its shard.
    ``device``: where this shard's tensors live, the card unless the caller
    asks for the CPU; a bare "cuda" is the process's current card.  NCCL
    carries CUDA tensors and gloo CPU ones, so a group of the one with a
    device of the other raises."""

    def __init__(self, group=None, device: Any = DEFAULT):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("DistMesh needs an initialised torch.distributed group")
        self._dist = dist
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self._rank = dist.get_rank(self.group)
        self.local_ranks = (self._rank,)
        backend = dist.get_backend(self.group)
        self.nccl = backend == "nccl"
        dev = resolve_device(device)
        if (dev.type == "cuda") != self.nccl:
            raise ValueError(
                f"a {backend} group does not carry tensors on {str(dev)!r}: NCCL takes "
                "CUDA tensors, gloo CPU ones (pass device='cpu' on a gloo group)")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev

    def __repr__(self):
        return f"DistMesh(rank {self._rank} of {self.size}, {self._device})"

    def device_of(self, rank: int) -> torch.device:
        if rank != self._rank:
            raise ValueError(f"rank {rank} is another process's shard")
        return self._device

    @property
    def index(self) -> int:
        return self._rank

    def _peer(self, rank: int) -> int:
        return self._dist.get_global_rank(self.group, rank)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _PsumFn.apply(x, self)

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        if _check_pairs(pairs, self.size).get(self._rank) == self._rank:
            return x  # (r, r): no communication, and the identity's adjoint
        return _PpermuteFn.apply(x, self, list(pairs))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return _AllGatherFn.apply(x, self)

    # The collectives themselves, on tensors that carry no graph (the
    # Functions' forwards and backwards).  Gloo wants contiguous tensors and
    # all_reduce works in place, so each takes a contiguous copy.

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        self._dist.all_reduce(out, op=self._dist.ReduceOp.SUM, group=self.group)
        return out

    def _ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        dist = self._dist
        by_dst = _check_pairs(pairs, self.size)
        r = self._rank
        out, ops = None, []
        src = by_dst.get(r)
        if src is not None:
            out = torch.empty_like(x, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, out, self._peer(src), self.group))
        dst = next((d for d, s in by_dst.items() if s == r and d != r), None)
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), self._peer(dst), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out if out is not None else torch.zeros_like(x)

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if self.nccl:
            out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            self._dist.all_gather_into_tensor(out, x, group=self.group)
            return out
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts)

    def _reduce_scatter(self, g: torch.Tensor) -> torch.Tensor:
        """Slice ``rank`` of ``g`` [size, ...] summed over ranks: NCCL's
        reduce_scatter; on gloo, which lacks it in some torch versions, an
        all_reduce and the slice."""
        if self.nccl:
            out = torch.empty(tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
            self._dist.reduce_scatter_tensor(out, g.contiguous(), op=self._dist.ReduceOp.SUM,
                                             group=self.group)
            return out
        return self._all_reduce(g)[self._rank].clone()

    def run(self, fn: Callable, *per_shard_args: Sequence) -> list:
        for a in per_shard_args:
            if len(a) != 1:
                raise ValueError(f"a DistMesh process runs one shard; got {len(a)} arguments")
        return [fn(*(a[0] for a in per_shard_args))]

    def gather(self, parts, axis: int) -> torch.Tensor:
        return torch.cat(list(self.all_gather(parts[0]).unbind(0)), dim=axis)


def _thread_devices(device: Any, n: int) -> list:
    """``n`` shards' devices: every card in turn for a bare "cuda", else the
    one device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = torch.cuda.device_count()
        return [torch.device("cuda", i % cards) for i in range(n)]
    return [dev] * n


def make_mesh(n_devices: int | None = None, *, device: Any = DEFAULT) -> Mesh:
    """A mesh of ``n_devices`` shards (``scythe_tpu.parallel.sharding.
    make_mesh``): a DistMesh over the default group where a torch.distributed
    group is initialised (the group's size; a subgroup's mesh is
    ``DistMesh(group, device)``), else a ThreadMesh.  ``device``: the card
    unless the caller asks for the CPU (raises without a card); a bare
    "cuda" is the current card of a DistMesh and puts ThreadMesh shards on
    every card in turn.  ``n_devices`` None: the group's size, or one
    ThreadMesh shard a card, one on the CPU."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        mesh = DistMesh(None, dev)
        if n_devices is not None and n_devices != mesh.size:
            raise ValueError(f"{n_devices} shards asked of a torch.distributed group of "
                             f"{mesh.size}")
        return mesh
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    return ThreadMesh(n_devices, _thread_devices(dev, n_devices))


def make_ensemble_mesh(n_devices: int | None = None, *, device: Any = DEFAULT) -> Mesh:
    """The mesh ``model.integrate_ensemble(..., mesh=...)`` splits its
    members over (``scythe_tpu.parallel.sharding.make_ensemble_mesh``):
    members are independent, so their shards never communicate.  The same
    arguments as ``make_mesh``."""
    return make_mesh(n_devices, device=device)
