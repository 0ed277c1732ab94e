"""Data-parallel simulation over ranks.

The reference parallelizes with `mp.Process` forks and file concatenation
(simulator.py:1571-1672).  Here a run of H hosts is H ranks with one card
each, and every batch of B read slots is split over them: rank h owns slots
[h*B/H, (h+1)*B/H).  That is the JAX package's contiguous device grouping
with one device a host, so the shards, and the files written from them, are
the JAX package's.  Because all randomness is keyed by global slot id
(ops/rng.py), a lane's result does not depend on which rank computes it.

Global read numbering comes from the ranks' accept counts: rank h numbers
its accepted lanes from ``prior + sum(counts[:h])``, which reproduces the
accept-order-by-slot numbering of a single-host run.

The counts are exchanged two ways behind one interface (HostGroup):

* emulated (no process group): one process computes every rank's shard, as
  H separate calls of B/H lanes on its own device, so that anything sized by
  the batch (packed-lane capacities, transfer capacities) is what the
  distributed run sizes; it reads the counts directly;
* distributed (torch.distributed initialized, see multihost.init_distributed):
  the rank computes its own shard only and all-gathers its accept count.

Each collective is the span `exchange` and counts `exchange.rounds`
(tracing.py): the time a rank waits there for the slowest one.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing


class HostGroup:
    """This process's rank among n_hosts, and the exchange of per-rank
    integers: a process group when torch.distributed is initialized (gloo,
    CPU tensors), else the emulated single process."""

    def __init__(self, n_hosts: int, host_id: int):
        if not 0 <= host_id < n_hosts:
            raise ValueError(f"host_id {host_id} is not a rank of {n_hosts} hosts")
        self.n_hosts = n_hosts
        self.host_id = host_id
        import torch.distributed as dist

        self.distributed = n_hosts > 1 and dist.is_available() and dist.is_initialized()
        if self.distributed and (dist.get_world_size() != n_hosts or dist.get_rank() != host_id):
            raise ValueError(
                f"the process group is rank {dist.get_rank()} of {dist.get_world_size()}, "
                f"not host {host_id} of {n_hosts}")

    def gather(self, value: int) -> np.ndarray:
        """Every rank's `value`, [n_hosts] int64 (distributed only)."""
        import torch.distributed as dist

        parts = [torch.zeros(1, dtype=torch.int64) for _ in range(self.n_hosts)]
        with tracing.span("exchange"):
            dist.all_gather(parts, torch.tensor([int(value)], dtype=torch.int64))
            tracing.count("exchange.rounds")
        return torch.cat(parts).numpy()

    def sum(self, values: np.ndarray) -> np.ndarray:
        """The element-wise sum over ranks of an int64 vector (distributed
        only)."""
        import torch.distributed as dist

        t = torch.as_tensor(np.asarray(values, np.int64)).clone()
        with tracing.span("exchange"):
            dist.all_reduce(t)
            tracing.count("exchange.rounds")
        return t.numpy()


def shard_sim_batch_numbered(batch_fn, group: HostGroup, count, reduce=None):
    """Wrap a batch function for sharded execution.

    ``batch_fn(slots, *lane_args)`` runs one shard: its slot ids (numpy
    int64) and its rows of any per-lane arguments.  The returned
    ``step(slots, *lane_args)`` takes a whole batch of B slots and returns
    (this rank's shard output, offsets [n_hosts] int64 -- every rank's
    exclusive prefix of accepted counts --, total accepted).  `count(out)`
    gives a shard's accepted count.  With
    `reduce`, ``reduce(out)`` gives an int64 vector per shard and the step
    also returns its sum over the ranks.

    Numbering a rank's reads ``prior + offsets[rank] + rank_within_shard``
    reproduces the accept-order-by-slot numbering of the single-host run
    (the analog of the reference's locked mp.Value counter,
    simulator.py:1573).
    """
    H, me = group.n_hosts, group.host_id

    def step(slots, *lane_args):
        B = len(slots)
        if B % H:
            raise ValueError(f"batch {B} not divisible by {H} devices")
        s = B // H

        def run(rank):
            sl = slice(rank * s, (rank + 1) * s)
            return batch_fn(slots[sl], *(a[sl] for a in lane_args))

        if group.distributed:
            out = run(me)
            counts = group.gather(count(out))
            reduced = group.sum(reduce(out)) if reduce is not None else None
        else:
            outs = [run(rank) for rank in range(H)]
            counts = np.array([count(o) for o in outs], np.int64)
            reduced = (np.sum([reduce(o) for o in outs], axis=0, dtype=np.int64)
                       if reduce is not None else None)
            out = outs[me]
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        total = int(counts.sum())
        if reduce is None:
            return out, offsets, total
        return out, offsets, total, reduced

    return step

