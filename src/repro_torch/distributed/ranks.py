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
* ``rank_comms(comm)`` pairs a rank's data-axis communicator (``launch``
  builds it) with its model-axis one, ``RankComm(mesh, "model")``, built
  after it on every rank (gloo deadlocks when ranks create groups in
  different orders): what a model's forward on a rank moves
  (``models/ranked.py``).
* The transport follows ``dist.get_backend()``: under NCCL the tensors
  stay on the device; gloo's point-to-point ops take CPU tensors only, so
  under gloo a CUDA tensor is staged through two pinned host buffers of
  the rank, reused across calls, ``STAGE_BYTES`` at a time.
* Every byte a rank sends goes through ``collectives.note_send``, so
  ``collectives.recording`` counts the traffic the rank really sends, by
  the reference's collective kinds: a shift is a ``collective-permute``
  of x's bytes (none for a multiple of A: the block stays on the rank);
  an all-gather sends x to the A - 1 others; an all-reduce counts
  2·(A - 1)/A of x's bytes, the ring algorithm's share a rank sends (the
  reference's ``analyze`` counts an all-reduce's wire bytes so), rounded
  down.  A column of one rank sends nothing.
* ``CountingComm(mesh, coords, axis)`` runs a rank body on ``meta``
  tensors without a group (``launch/dryrun.py``): ``shift``,
  ``all_gather`` and ``all_reduce`` note what ``RankComm`` notes and
  return an empty tensor of the result's shape.  It notes every shift, one
  of a multiple of A included, as the reference's HLO holds a
  ``collective-permute`` for every ``ppermute``; with no such shift (every
  mesh the ranks run on in the tests and ``chip_smoke.py``) the two
  count the same bytes.  ``counting_comms(mesh, coords)`` is
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
        self.group = None
        others = [range(n) for i, n in enumerate(mesh.axis_sizes)
                  if i != self.data_dim]
        for col in itertools.product(*others):
            ranks = []
            for i in range(self.axis_size):
                c = list(col)
                c.insert(self.data_dim, i)
                ranks.append(mesh.rank_of(c))
            group = dist.new_group(ranks)
            if self.rank in ranks:
                self.group = group
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

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the column's blocks, in x's dtype: a new tensor
        like ``x`` (contiguous), the same on every rank of the column."""
        out = x.clone(memory_format=torch.contiguous_format)
        if self.axis_size == 1:
            return out
        self._note_reduce(x)
        if not self._staged(x):
            dist.all_reduce(out, group=self.group)
            return out
        nb = x.numel() * x.element_size()
        buf = self._buffers(x.device, nb)[0][:nb].view(x.dtype) \
            .view(x.shape)
        buf.copy_(out)
        dist.all_reduce(buf, group=self.group)
        out.copy_(buf)
        return out


class CountingComm(_Column):
    """A rank body's moves counted on ``meta`` tensors, with no group
    (module notes)."""

    def shift(self, x: torch.Tensor, s: int) -> torch.Tensor:
        note_send(x, PERMUTE)
        return torch.empty_like(x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._note_gather(x)
        return x.new_empty((self.axis_size,) + tuple(x.shape))

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis_size > 1:
            self._note_reduce(x)
        return torch.empty_like(x, memory_format=torch.contiguous_format)


class AxisComms(NamedTuple):
    """A rank's communicators of a (data, model) mesh."""
    data: _Column
    model: _Column

    @property
    def mesh(self):
        return self.data.mesh

    @property
    def coords(self) -> tuple:
        return self.data.coords


def rank_comms(data: RankComm) -> AxisComms:
    """This rank's data-axis communicator (the one ``launch`` passes a
    rank body) and its model-axis communicator, built after it (module
    notes)."""
    return AxisComms(data, RankComm(data.mesh, "model"))


def counting_comms(mesh, coords) -> AxisComms:
    """``rank_comms``' counting twin for the position at ``coords``."""
    return AxisComms(CountingComm(mesh, coords, "data"),
                     CountingComm(mesh, coords, "model"))


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
