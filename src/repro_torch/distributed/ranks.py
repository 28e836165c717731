"""Mesh positions as ranks of a ``torch.distributed`` process group.

The reference runs its EC store inside ``shard_map``: one device per mesh
position, blocks moved between devices by ``ppermute`` and
``all_gather`` over the data axis (``src/repro/distributed/
collectives.py``).  Here a position can be a rank: rank r holds position
``mesh.coords(r)`` and runs what that device runs
(``ecstore.rank_*``, ``collectives.rank_*``), and a communicator moves
its blocks.

* ``RankComm(mesh, axis="data")`` wraps the default process group, which
  the caller initialised with the backend of its choice: the rank's mesh
  coordinate, and the subgroup of its column along ``axis`` (the ranks
  that differ from it on that axis only; every rank creates every
  column's group, in one order).  ``shift(x, s)`` sends ``x`` to index
  (d + s) mod A and receives from (d - s) mod A, as one
  ``dist.batch_isend_irecv``; ``all_gather(x)`` gathers the column's
  blocks in axis order (under gloo as A - 1 such exchanges, under NCCL
  one ``dist.all_gather``); ``all_reduce(x)`` sums them
  (``dist.all_reduce``), the same sum on every rank of the column.
* ``reduce_scatter(x)`` takes every index's contribution ``(A, *block)``
  and returns the column's sum of the rank's own block (under gloo A - 1
  exchanges and a sum in axis order, in fp32 for a floating dtype; under
  NCCL ``dist.reduce_scatter_tensor``): the transpose of ``all_gather``.
* ``rank_comms(comm)`` gives a rank's data-axis communicator (``launch``
  builds it) its model-axis one and, on a (pod, data, model) mesh, its
  pod-axis one: what a model on a rank moves (``models/ranked.py``).
  The first ``RankComm`` of a mesh creates the groups of every axis, in
  the mesh's axis order (pod, data, model), and later ones reuse them:
  gloo deadlocks when ranks create groups in different orders.
* Under autograd (``all_gather``, ``all_gather_rows``, ``all_reduce`` and
  ``sum_grad`` of this module, each taking a communicator): a gather of
  parameter blocks, which every index uses for its own part of the work,
  has a reduce-scatter for its backward (the column's gradient
  contributions summed, the rank keeping its block's); a gather of
  activation rows whose result every index holds alike (and so holds the
  whole gradient of) takes its own rows of the gradient; an all-reduce
  of partial sums into a value every index holds alike passes the
  gradient through; and ``sum_grad``, the identity forward, all-reduces
  the gradient of a value replicated over the column that each index
  uses for its own part of the work.  With no gradient to record they
  are the communicator's own calls.
* The transport follows ``dist.get_backend()``: under NCCL the tensors
  stay on the device; gloo's point-to-point ops take CPU tensors only, so
  under gloo a CUDA tensor is staged through two pinned host buffers of
  the rank, reused across calls, ``STAGE_BYTES`` at a time.
* Every byte a rank sends goes through ``collectives.note_send``, so
  ``collectives.recording`` counts the traffic the rank really sends, by
  the reference's collective kinds: a shift is a ``collective-permute``
  of x's bytes (none for a multiple of A: the block stays on the rank);
  an all-gather sends x to the A - 1 others, and a reduce-scatter the
  A - 1 blocks of the others (the kept block's bytes A - 1 times, the
  gather's formula); an all-reduce counts 2·(A - 1)/A of x's bytes, the
  ring algorithm's share a rank sends (the reference's ``analyze``
  counts an all-reduce's wire bytes so), rounded down.  A column of one
  rank sends nothing.
* ``CountingComm(mesh, coords, axis)`` runs a rank body on ``meta``
  tensors without a group (``launch/dryrun.py``): ``shift``,
  ``all_gather``, ``reduce_scatter`` and ``all_reduce`` note what
  ``RankComm`` notes and return an empty tensor of the result's shape;
  on a column of one rank ``all_gather`` and ``all_reduce`` return a
  copy of the block, as ``RankComm``'s do, so that autograd follows a
  parameter through them to the backward's moves beyond (a (1, M) mesh's
  data gathers).  It notes every shift, one
  of a multiple of A included, as the reference's HLO holds a
  ``collective-permute`` for every ``ppermute``; with no such shift the
  two count the same bytes, and ``CountingComm(..., count_stays=False)``
  leaves such shifts out, as a rank sends nothing for them (the dry
  run's count of a rank's train step, ``dryrun.count_rank_train``).  ``counting_comms(mesh, coords)`` is
  ``rank_comms``' twin.

``launch(fn, mesh, rank_args, init_file=...)`` spawns one process per
rank (``torch.multiprocessing``, spawn), initialises the group through a
``file://`` store, runs ``fn(comm, *rank_args[r])`` in rank r and returns
the results by rank.  Tensors in ``rank_args`` are shared with the ranks,
not copied (CUDA tensors through CUDA IPC, CPU tensors through shared
memory); a rank drops them before it answers, so that the caller's CUDA
memory goes back to its allocator when the caller frees it.  A rank that
raises fails the call, and so does a deadline: every rank still running
is then killed.
"""
from __future__ import annotations

import datetime
import gc
import itertools
import queue
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

from .collectives import PERMUTE, note_bytes, note_send

GATHER = "all-gather"
REDUCE = "all-reduce"
SCATTER = "reduce-scatter"

#: bytes a gloo rank stages through host memory per exchange
STAGE_BYTES = 64 << 20


class _Column:
    """A position's place on its column along ``axis``: ``coords`` on
    ``mesh``, index ``index`` of ``axis_size`` on the axis, and the ranks
    of the column in axis order (``members``).  ``op_paths`` records the
    dispatch path each EC operation's GF(2^8) products took on the rank
    (as the coding engines' ``op_paths``)."""

    def __init__(self, mesh, coords, axis: str = "data"):
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh {mesh.axis_names}")
        self.mesh = mesh
        self.axis = axis
        self.coords = tuple(int(c) for c in coords)
        self.rank = mesh.rank_of(self.coords)
        self.data_dim = tuple(mesh.axis_names).index(axis)
        self.axis_size = int(mesh.axis_sizes[self.data_dim])
        self.index = self.coords[self.data_dim]
        self.members = [mesh.rank_of(self._at(i))
                        for i in range(self.axis_size)]
        self.op_paths: dict[str, str] = {}

    def _at(self, i: int) -> tuple:
        c = list(self.coords)
        c[self.data_dim] = i
        return tuple(c)

    def _note_gather(self, x: torch.Tensor) -> None:
        """x sent to each other index (the A - 1 exchanges of a gather)."""
        for _ in range(self.axis_size - 1):
            note_send(x, GATHER)

    def _note_scatter(self, block: torch.Tensor) -> None:
        """The A - 1 other indices' blocks sent to them (a reduce-scatter
        keeping ``block``'s shape): the gather's formula."""
        for _ in range(self.axis_size - 1):
            note_send(block, SCATTER)

    def _note_reduce(self, x: torch.Tensor) -> None:
        """A ring all-reduce's bytes a rank sends, 2 (A - 1) / A of x: a
        model, not a measurement, as gloo and NCCL pick their own
        algorithm; the rank and its ``CountingComm`` note the same."""
        A = self.axis_size
        note_bytes(2 * (A - 1) * x.numel() * x.element_size() // A, REDUCE)


class RankComm(_Column):
    """The default process group's rank as a mesh position (module
    notes)."""

    def __init__(self, mesh, axis: str = "data"):
        if not dist.is_initialized():
            raise RuntimeError("RankComm needs an initialised process group")
        if dist.get_world_size() != mesh.size:
            raise ValueError(f"{dist.get_world_size()} ranks for a mesh of "
                             f"{mesh.size} positions")
        super().__init__(mesh, mesh.coords(dist.get_rank()), axis)
        self.backend = dist.get_backend()
        self.group = _axis_groups(mesh, self.rank)[axis]
        self._stage: dict = {}

    def _staged(self, x: torch.Tensor) -> bool:
        return x.device.type == "cuda" and self.backend == "gloo"

    def _buffers(self, device, nbytes: int) -> tuple:
        """The rank's two pinned staging buffers for ``device``, grown to
        at least ``nbytes``."""
        bufs = self._stage.get(device)
        if bufs is None or bufs[0].numel() < nbytes:
            bufs = tuple(torch.empty(max(nbytes, STAGE_BYTES),
                                     dtype=torch.uint8, pin_memory=True)
                         for _ in range(2))
            self._stage[device] = bufs
        return bufs

    @staticmethod
    def _exchange(send: torch.Tensor, recv: torch.Tensor, dst: int,
                  src: int) -> None:
        ops = [dist.P2POp(dist.isend, send, dst),
               dist.P2POp(dist.irecv, recv, src)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    def shift(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """The block of data index (d - s) mod A; ``x`` goes to (d + s)
        mod A.  A new tensor like ``x`` (contiguous)."""
        A = self.axis_size
        s = int(s) % A
        if s == 0:
            return x.clone(memory_format=torch.contiguous_format)
        dst = self.members[(self.index + s) % A]
        src = self.members[(self.index - s) % A]
        note_send(x, PERMUTE)
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        if not self._staged(x):
            self._exchange(x.contiguous(), out, dst, src)
            return out
        rows = x.shape[0] if x.dim() else 1
        x2 = x.reshape(rows, -1)              # a view for a page column
        o2 = out.view(rows, -1)
        row_bytes = x2.shape[1] * x.element_size()
        per = max(1, STAGE_BYTES // max(row_bytes, 1))
        send_buf, recv_buf = self._buffers(x.device, per * row_bytes)
        for r0 in range(0, rows, per):
            n = min(per, rows - r0)
            nb = n * row_bytes
            send = send_buf[:nb].view(x.dtype).view(n, -1)
            recv = recv_buf[:nb].view(x.dtype).view(n, -1)
            send.copy_(x2[r0:r0 + n])         # device to host, waits
            self._exchange(send, recv, dst, src)
            o2[r0:r0 + n].copy_(recv)         # host to device, waits
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(A, *x.shape)``: every index's block of the column, in axis
        order."""
        A = self.axis_size
        self._note_gather(x)
        out = torch.empty((A,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        if self.backend != "gloo":
            dist.all_gather(list(out.unbind(0)), x.contiguous(),
                            group=self.group)
            return out
        # gloo: A - 1 ring exchanges of x, point to point (gloo's own
        # all-gather moves a third of their bytes a second on one host)
        out[self.index].copy_(x)
        staged = self._staged(x)
        if staged:
            nb = x.numel() * x.element_size()
            send_buf, recv_buf = self._buffers(x.device, nb)
            send = send_buf[:nb].view(x.dtype).view(x.shape)
            send.copy_(x)
            recv = recv_buf[:nb].view(x.dtype).view(x.shape)
        else:
            send = x.contiguous()
        for s in range(1, A):
            src = (self.index - s) % A
            self._exchange(send, recv if staged else out[src],
                           self.members[(self.index + s) % A],
                           self.members[src])
            if staged:
                out[src].copy_(recv)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The column's sum of block ``self.index`` of ``x`` (``(A,
        *block)``, every index's contribution): a new tensor of the
        block's shape in x's dtype, summed in axis order (in fp32 for a
        floating dtype) under gloo."""
        A = self.axis_size
        if x.shape[0] != A:
            raise ValueError(f"{tuple(x.shape)}: expected {A} blocks")
        x = x.contiguous()
        if A == 1:
            return x[0].clone()
        self._note_scatter(x[0])
        if self.backend != "gloo":
            out = torch.empty_like(x[0])
            dist.reduce_scatter_tensor(out, x, group=self.group)
            return out
        parts = torch.empty_like(x)
        parts[self.index].copy_(x[self.index])
        staged = self._staged(x)
        if staged:
            nb = x[0].numel() * x.element_size()
            send_buf, recv_buf = self._buffers(x.device, nb)
            send = send_buf[:nb].view(x.dtype).view(x.shape[1:])
            recv = recv_buf[:nb].view(x.dtype).view(x.shape[1:])
        for s in range(1, A):
            dst, src = (self.index + s) % A, (self.index - s) % A
            if staged:
                send.copy_(x[dst])
            self._exchange(send if staged else x[dst],
                           recv if staged else parts[src],
                           self.members[dst], self.members[src])
            if staged:
                parts[src].copy_(recv)
        if x.dtype.is_floating_point:
            return parts.sum(dim=0, dtype=torch.float32).to(x.dtype)
        return parts.sum(dim=0).to(x.dtype)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the largest) of the column's blocks, in
        x's dtype: a new tensor like ``x`` (contiguous), the same on every
        rank of the column."""
        out = x.clone(memory_format=torch.contiguous_format)
        if self.axis_size == 1:
            return out
        self._note_reduce(x)
        red = _REDUCE_OPS[op]
        if not self._staged(x):
            dist.all_reduce(out, op=red, group=self.group)
            return out
        nb = x.numel() * x.element_size()
        buf = self._buffers(x.device, nb)[0][:nb].view(x.dtype) \
            .view(x.shape)
        buf.copy_(out)
        dist.all_reduce(buf, op=red, group=self.group)
        out.copy_(buf)
        return out


class CountingComm(_Column):
    """A rank body's moves counted on ``meta`` tensors, with no group
    (module notes)."""

    def __init__(self, mesh, coords, axis: str = "data",
                 count_stays: bool = True):
        super().__init__(mesh, coords, axis)
        self.count_stays = count_stays

    def shift(self, x: torch.Tensor, s: int) -> torch.Tensor:
        if self.count_stays or int(s) % self.axis_size:
            note_send(x, PERMUTE)
        return torch.empty_like(x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._note_gather(x)
        if self.axis_size == 1:              # ``RankComm``'s copy
            return x.unsqueeze(0).clone()
        return x.new_empty((self.axis_size,) + tuple(x.shape))

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis_size > 1:
            self._note_scatter(x[0])
        return x.new_empty(tuple(x.shape[1:]))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        _REDUCE_OPS[op]
        if self.axis_size == 1:              # ``RankComm``'s copy
            return x.clone(memory_format=torch.contiguous_format)
        self._note_reduce(x)
        return torch.empty_like(x, memory_format=torch.contiguous_format)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

#: groups by (default group, mesh): {axis: this rank's column's group}
_GROUPS: dict = {}


def _axis_groups(mesh, rank: int) -> dict:
    """This rank's group on every axis of ``mesh``, created on first use
    for every column of every axis, in the mesh's axis order (module
    notes)."""
    key = (id(dist.group.WORLD), tuple(mesh.axis_names),
           tuple(mesh.axis_sizes))
    if key in _GROUPS:
        return _GROUPS[key]
    mine = {}
    for d, axis in enumerate(mesh.axis_names):
        others = [range(n) for i, n in enumerate(mesh.axis_sizes) if i != d]
        for col in itertools.product(*others):
            ranks = []
            for i in range(mesh.axis_sizes[d]):
                c = list(col)
                c.insert(d, i)
                ranks.append(mesh.rank_of(c))
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = group
    _GROUPS[key] = mine
    return mine


class AxisComms(NamedTuple):
    """A rank's communicators of a (data, model) or (pod, data, model)
    mesh (``pod`` None on a mesh without that axis)."""
    data: _Column
    model: _Column
    pod: _Column | None = None

    def columns(self) -> list:
        """The rank's communicators, in the mesh's axis order."""
        return [c for c in (self.pod, self.data, self.model)
                if c is not None]

    @property
    def mesh(self):
        return self.data.mesh

    @property
    def coords(self) -> tuple:
        return self.data.coords


def rank_comms(data: RankComm) -> AxisComms:
    """This rank's data-axis communicator (the one ``launch`` passes a
    rank body), its model-axis one and, on a mesh with a "pod" axis, its
    pod-axis one (module notes)."""
    pod = RankComm(data.mesh, "pod") if "pod" in data.mesh.axis_names \
        else None
    return AxisComms(data, RankComm(data.mesh, "model"), pod)


def counting_comms(mesh, coords) -> AxisComms:
    """``rank_comms``' counting twin for the position at ``coords``."""
    pod = CountingComm(mesh, coords, "pod") if "pod" in mesh.axis_names \
        else None
    return AxisComms(CountingComm(mesh, coords, "data"),
                     CountingComm(mesh, coords, "model"), pod)


# ---------------------------------------------------------------------------
# collectives under autograd
# ---------------------------------------------------------------------------

def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.index = comm.index
        return comm.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


def all_gather(comm, x: torch.Tensor) -> torch.Tensor:
    """``comm.all_gather(x)`` of parameter blocks; its backward is
    ``comm.reduce_scatter`` (module notes)."""
    if comm.axis_size == 1 or not _records(x):
        return comm.all_gather(x)
    return _GatherBlocks.apply(x, comm)


def all_gather_rows(comm, x: torch.Tensor) -> torch.Tensor:
    """``comm.all_gather(x)`` of activation rows that every index then
    holds alike; its backward takes the rank's own block (module notes)."""
    if comm.axis_size == 1 or not _records(x):
        return comm.all_gather(x)
    return _GatherRows.apply(x, comm)


def all_reduce(comm, x: torch.Tensor) -> torch.Tensor:
    """``comm.all_reduce(x)`` of partial sums into a value every index
    holds alike; its backward passes the gradient through (module
    notes)."""
    if comm.axis_size == 1 or not _records(x):
        return comm.all_reduce(x)
    return _SumPartials.apply(x, comm)


def sum_grad(comm, x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient the column sums: a value replicated
    over the column that each index uses for its own part of the work
    (module notes)."""
    if comm.axis_size == 1 or not _records(x):
        return x
    return _SumGrad.apply(x, comm)


# ---------------------------------------------------------------------------
# spawning the ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, mesh, backend: str, init_file: str,
               timeout: float, inbox, results) -> None:
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}",
            world_size=mesh.size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        args = inbox.get(timeout=timeout)
        result = fn(RankComm(mesh), *args)
        # drop the shared tensors before answering: a CUDA block shared
        # with a rank returns to its owner only once the rank lets go
        del args
        gc.collect()
        results.put((rank, None, result))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, mesh, rank_args=None, *, init_file: str,
           backend: str = "gloo", timeout: float = 120.0) -> list:
    """Run ``fn(comm, *rank_args[r])`` on ``mesh.size`` spawned ranks and
    return their results, by rank.  ``fn`` must be importable (a module's
    top-level function) and return picklable values; ``init_file`` is a
    path that does not exist yet, for the group's ``file://`` store.
    Raises if a rank raises or exits without a result, or if the ranks
    have not all returned within ``timeout`` seconds; every rank still
    running is then killed."""
    n = mesh.size
    rank_args = [()] * n if rank_args is None else list(rank_args)
    if len(rank_args) != n:
        raise ValueError(f"{len(rank_args)} argument tuples for {n} ranks")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    inboxes = [ctx.Queue() for _ in range(n)]
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, mesh, backend, init_file, timeout, inboxes[r], results))
        for r in range(n)]
    deadline = time.monotonic() + timeout
    out: dict = {}
    try:
        for p, inbox, args in zip(procs, inboxes, rank_args):
            p.start()
            inbox.put(tuple(args))
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(n)) - set(out))}"
                                   f" did not return within {timeout} s")
            try:
                rank, err, result = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                gone = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if gone:
                    raise RuntimeError(f"ranks {gone} exited without a "
                                       f"result (exit codes "
                                       f"{[procs[r].exitcode for r in gone]})")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{err}")
            out[rank] = result
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        for q in inboxes:
            q.cancel_join_thread()      # a killed rank reads nothing more
            q.close()
        results.close()
    return [out[r] for r in range(n)]
