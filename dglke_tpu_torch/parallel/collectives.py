"""The collectives of a --dist run, over torch.distributed, each counted.

One process per rank, one device per process.  The backend follows from
the layout and is chosen once, before the process group starts
(mesh.init_distributed):

  * each rank on a card of its own: NCCL, on the card's tensors;
  * ranks that share a card, or ranks on the CPU: gloo.  A CUDA tensor
    is staged through host memory: copied to the CPU, the collective run
    there, the result copied back (gloo's own support for CUDA tensors
    differs from one collective to the next, so it is not relied on).

Nothing falls back from one backend to the other.  A tensor on another
device than the collective's (a CPU count under NCCL) is moved there and
its result moved back.  Every collective adds
to ``Comm.bytes`` the bytes of the tensors it is handed and of those it
returns on this rank (the rank's own part included), and to ``Comm.ms``
its time on the host clock: on the staged route the copies and the
collective, on NCCL the time to enqueue it.  The plans' collectives carry
batch-sized tensors only, never a table, and take no shape or split that
is read from the device: under NCCL a CUDA graph captures them
(models/cuda_graphs.py).  A replay runs no Python, so a capture's bytes
are taken back out (``take_bytes``) and each replay adds them
(``add_bytes``), as rows.take_launches / rows.add_launches treat kernel
launches; ``ms`` counts eager calls only, and a replay is timed as a
whole by its span.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Comm:
    """This rank of the process group: its index, the world, its device and
    backend, and the counted collectives the plans use."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, layout: str = ""):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.layout = layout
        # the collective's own device: host memory under gloo (CUDA
        # tensors are staged through it), the card under NCCL
        self.wire = (torch.device("cpu") if backend == "gloo"
                     else self.device)
        self.reset_counters()

    # -- counters ------------------------------------------------------------

    def reset_counters(self) -> None:
        self.bytes = 0
        self.ms = 0.0

    def counters(self) -> dict:
        return {"bytes": self.bytes, "ms": self.ms}

    def take_bytes(self, before: dict) -> int:
        """The bytes counted since ``before`` (a copy of counters()), taken
        back out with the ms: a capture enqueues its collectives into a
        graph and moves nothing."""
        n = self.bytes - before["bytes"]
        self.bytes, self.ms = before["bytes"], before["ms"]
        return n

    def add_bytes(self, n: int) -> None:
        """Count ``n`` bytes, those one replay of a graph moves."""
        self.bytes += n

    def _count(self, t0: float, *tensors: torch.Tensor) -> None:
        self.ms += (time.perf_counter() - t0) * 1e3
        self.bytes += sum(_nbytes(t) for t in tensors)

    # -- collectives ---------------------------------------------------------

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (the same shape on every rank), concatenated
        along dim 0 in rank order."""
        t0 = time.perf_counter()
        src = x.to(self.wire).contiguous()
        out = torch.empty((self.world * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=self.wire)
        if x.numel():
            dist.all_gather(list(out.chunk(self.world)), src)
        out = out.to(x.device)
        self._count(t0, x, out)
        return out

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Equal blocks: ``x`` [n * C, ...] holds C rows for each rank, in
        rank order; returns the C rows each rank holds for this one, in
        rank order, [n * C, ...].  No split list: nothing is read on the
        host."""
        t0 = time.perf_counter()
        src = x.to(self.wire).contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        out = out.to(x.device)
        self._count(t0, x, out)
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise sum (or "min") of ``x`` over the ranks, as a new
        tensor on x's device."""
        t0 = time.perf_counter()
        buf = x.to(self.wire, copy=True)
        dist.all_reduce(buf, {"sum": dist.ReduceOp.SUM,
                              "min": dist.ReduceOp.MIN}[op])
        out = buf.to(x.device)
        self._count(t0, x, out)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (a new tensor)."""
        t0 = time.perf_counter()
        buf = x.to(self.wire, copy=True)
        dist.broadcast(buf, src)
        out = buf.to(x.device)
        self._count(t0, x, out)
        return out

    def send(self, x: torch.Tensor, dst: int) -> None:
        t0 = time.perf_counter()
        dist.send(x.to(self.wire).contiguous(), dst)
        self._count(t0, x)

    def recv(self, shape, dtype, src: int, device=None) -> torch.Tensor:
        """A tensor of ``shape`` / ``dtype`` from rank ``src``, on
        ``device`` (this rank's device when omitted)."""
        t0 = time.perf_counter()
        buf = torch.empty(shape, dtype=dtype, device=self.wire)
        dist.recv(buf, src)
        out = buf.to(self.device if device is None else device)
        self._count(t0, out)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

