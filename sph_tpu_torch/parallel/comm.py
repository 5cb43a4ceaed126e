"""The four collectives of the multi-GPU engines, over ``torch.distributed``.

``sph_tpu`` runs its sharded engines under ``shard_map``: one function a
device, with ``lax`` collectives inside. The port runs one process a rank,
each calling the same rank function with a :class:`Comm`, which offers
exactly the operations ``sph_tpu/parallel/halo.py`` and ``sharded.py`` use:

=====================================  ====================  ==============
sph_tpu                                ``Comm``              torch
=====================================  ====================  ==============
``lax.all_gather(a, ax, tiled=True)``  ``all_gather(a)``     all-gather into
                                                             one tensor
``lax.psum(a, ax)``                    ``psum(a)``           ``all_reduce``
``lax.ppermute`` to rank + 1 / - 1     ``send_next(a, f)`` / ``batch_isend_
                                       ``send_prev(a, f)``   irecv``
``lax.axis_index(ax)``                 ``rank``              the group rank
=====================================  ====================  ==============

``send_next`` returns what the previous rank sent (``sph_tpu``'s forward
permutation); ``send_prev`` what the next rank sent. The chain's ends
receive nothing: they return the fill ``f`` (a scalar, or a tensor that
broadcasts to ``a``), where ``sph_tpu`` masks the zeros ``ppermute`` leaves
there.

A world of one (no process group) does all four locally. Under a process
group the backend is the group's, named by whoever started it:

* ``gloo`` moves the tensors through host memory: a CUDA tensor is copied
  to a pinned host buffer before each collective and back after it (gloo's
  point-to-point ops are never handed a device pointer);
* ``nccl`` passes device tensors straight through; it needs a card a rank
  (NCCL refuses two ranks on one device), which :class:`Comm` checks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# torch 2.13 renamed all_gather_into_tensor (kept, deprecated) to
# all_gather_single; earlier releases have only the first name
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


class Comm:
    """A rank's view of the 1-D chain of the default process group's ranks
    (the particle axis), or of a world of one when no group is
    initialized. ``device``: where this rank's tensors live (the card
    unless the caller names the CPU). ``backend``, when given, must be the
    group's."""

    def __init__(self, device="cuda", backend: str | None = None):
        self.device = torch.device(device)
        if not dist.is_initialized():
            self.rank, self.world, self.backend = 0, 1, None
            return
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = str(dist.get_backend()).lower()
        if backend is not None and backend != self.backend:
            raise ValueError(f"the process group's backend is "
                             f"{self.backend}, not {backend}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend}: the engines run on "
                             f"{' or '.join(BACKENDS)}")
        if self.backend == "nccl":
            self._check_nccl_devices()

    def _check_nccl_devices(self):
        """NCCL refuses two ranks on one card: name the clash here."""
        if self.device.type != "cuda":
            raise ValueError("nccl moves CUDA tensors; this rank's device "
                             f"is {self.device}")
        side = dist.new_group(backend="gloo")
        mine = (_host_name(), torch.cuda.current_device()
                if self.device.index is None else self.device.index)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine, group=side)
        dist.destroy_process_group(side)
        if len(set(every)) < len(every):
            raise ValueError(
                "nccl needs a distinct card a rank; ranks name the "
                f"(host, device) pairs {every}. Use gloo to share a card")

    # ------------------------------------------------------------------
    # the four operations
    # ------------------------------------------------------------------

    def all_gather(self, a: torch.Tensor) -> torch.Tensor:
        """Every rank's ``a`` concatenated along dim 0, in rank order."""
        if self.world == 1:
            return a
        x = self._out(a)
        out = torch.empty((self.world * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _ALL_GATHER(out, x)
        return self._in(out, a)

    def psum(self, a: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``a``."""
        if self.world == 1:
            return a
        x = self._out(a).clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return self._in(x, a)

    def send_next(self, a: torch.Tensor, fill=0) -> torch.Tensor:
        """Send ``a`` to rank + 1; return what rank - 1 sent (rank 0: the
        fill)."""
        return self._shift(a, fill, to=self.rank + 1, frm=self.rank - 1)

    def send_prev(self, a: torch.Tensor, fill=0) -> torch.Tensor:
        """Send ``a`` to rank - 1; return what rank + 1 sent (the last rank:
        the fill)."""
        return self._shift(a, fill, to=self.rank - 1, frm=self.rank + 1)

    # ------------------------------------------------------------------

    def pmax(self, a: torch.Tensor) -> torch.Tensor:
        """The max over ranks of a scalar ``a`` (through ``all_gather``)."""
        return self.all_gather(a.reshape(1)).max()

    def _shift(self, a, fill, to, frm):
        if not 0 <= frm < self.world:
            out = torch.empty_like(a)
            out.copy_(torch.as_tensor(fill, dtype=a.dtype,
                                      device=a.device).expand_as(a))
            if 0 <= to < self.world:        # still send ours on
                self._p2p(a, None, to, frm)
            return out
        recv = (torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                if self._staged(a) else torch.empty_like(a))
        self._p2p(a, recv, to, frm)
        return self._in(recv, a)

    def _p2p(self, a, recv, to, frm):
        ops = []
        if 0 <= to < self.world:
            ops.append(dist.P2POp(dist.isend, self._out(a).contiguous(), to))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, frm))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    def _staged(self, a):
        return self.backend == "gloo" and a.device.type != "cpu"

    def _out(self, a):
        """The tensor handed to the backend: gloo gets host memory."""
        if self._staged(a):
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            host.copy_(a)
            return host
        return a.contiguous()

    def _in(self, x, like):
        """A result back on ``like``'s device."""
        return x.to(like.device) if x.device != like.device else x


def _host_name() -> str:
    import socket

    return socket.gethostname()
