"""The communication seam of the parallel layer: a rank count, the ranks
a process hosts, and four collectives.

Every collective takes one tensor (or one list of segments) per hosted
rank, in ``ranks`` order, and returns one result per hosted rank:

* ``all_reduce(xs, op)``: the elementwise sum ("sum") or maximum ("max")
  over all ranks;
* ``all_gather(xs, dim)``: every rank's tensor (all of one shape),
  concatenated in rank order along ``dim``;
* ``all_to_all(segs)``: ``segs[i][s]`` is hosted rank i's segment for
  rank s; the result ``[i][s]`` is what rank s sent to hosted rank i.
  Segments are exact-size: the counts are exchanged first, so nothing is
  capped or dropped.

``ProcessGroup`` hosts one rank of a ``torch.distributed`` group (NCCL
for CUDA tensors, gloo for CPU ones) and calls the collective on it.
``Loopback(n)`` hosts all n ranks in one process and moves tensors
between their lists: a concatenation, a transpose of the segments, a sum
in rank order. Neither skips a collective when there is one rank.
``calls`` counts each collective a group ran.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import torch


class Loopback:
    """n ranks in one process."""

    backend = "loopback"

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a loopback needs at least one rank, not {n}")
        self.size = n
        self.ranks = tuple(range(n))
        self.calls = Counter()

    def _check(self, xs):
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} inputs for {self.size} hosted "
                             f"ranks")

    def all_reduce(self, xs: Sequence[torch.Tensor], op: str = "sum"
                   ) -> List[torch.Tensor]:
        self._check(xs)
        self.calls["all_reduce"] += 1
        out = xs[0].clone()
        for x in xs[1:]:
            if op == "sum":
                out = out + x
            elif op == "max":
                out = torch.maximum(out, x)
            else:
                raise ValueError(f"all_reduce op {op!r}")
        return [out.clone() for _ in xs]

    def all_gather(self, xs: Sequence[torch.Tensor], dim: int = 0
                   ) -> List[torch.Tensor]:
        self._check(xs)
        self.calls["all_gather"] += 1
        out = torch.cat(list(xs), dim=dim)
        return [out.clone() for _ in xs]

    def all_to_all(self, segs: Sequence[Sequence[torch.Tensor]]
                   ) -> List[List[torch.Tensor]]:
        self._check(segs)
        self.calls["all_to_all"] += 1
        return [[segs[s][i] for s in range(self.size)]
                for i in range(self.size)]

    def barrier(self):
        self.calls["barrier"] += 1


class ProcessGroup:
    """This process's rank of the default ``torch.distributed`` group."""

    def __init__(self):
        import torch.distributed as dist
        self._dist = dist
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.ranks = (self.rank,)
        self.backend = str(dist.get_backend())
        self.calls = Counter()

    def _one(self, xs):
        if len(xs) != 1:
            raise ValueError(f"{len(xs)} inputs for one hosted rank")
        return xs[0]

    def all_reduce(self, xs, op: str = "sum"):
        ops = {"sum": self._dist.ReduceOp.SUM, "max": self._dist.ReduceOp.MAX}
        if op not in ops:
            raise ValueError(f"all_reduce op {op!r}")
        out = self._one(xs).contiguous().clone()
        self._dist.all_reduce(out, op=ops[op])
        self.calls["all_reduce"] += 1
        return [out]

    def all_gather(self, xs, dim: int = 0):
        x = self._one(xs).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x)
        self.calls["all_gather"] += 1
        return [torch.cat(parts, dim)]

    def all_to_all(self, segs):
        row = self._one(segs)
        if len(row) != self.size:
            raise ValueError(f"{len(row)} segments for {self.size} ranks")
        x0 = row[0]
        send = torch.tensor([s.shape[0] for s in row], dtype=torch.int64,
                            device=x0.device)
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send)
        recv_n = recv.tolist()
        flat = torch.cat([s.contiguous() for s in row], 0)
        out = flat.new_empty((sum(recv_n),) + tuple(x0.shape[1:]))
        self._dist.all_to_all_single(out, flat, output_split_sizes=recv_n,
                                     input_split_sizes=send.tolist())
        self.calls["all_to_all"] += 1
        return [list(out.split(recv_n, 0))]

    def barrier(self):
        if self.backend == "nccl":
            # NCCL's barrier needs the rank's device; a one-element
            # all-reduce on it synchronizes the same way
            dev = torch.device("cuda", torch.cuda.current_device())
            self._dist.all_reduce(torch.zeros(1, device=dev))
        else:
            self._dist.barrier()
        self.calls["barrier"] += 1
