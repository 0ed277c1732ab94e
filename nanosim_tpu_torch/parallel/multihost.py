"""Multi-host simulation runs: per-host output shards, global numbering.

The reference scales by forking `mp.Process` workers that each write private
subfiles, merged afterwards by concatenation (simulator.py:1571-1672).  Here
every rank walks the same global slot schedule, runs its own shard of every
batch (parallel/mesh.py), emits only its own accepted lanes, at globally
numbered indices, into host-local `_h<id>` files: the union of the shards is
the single-host output up to record order, and merging them is plain
concatenation, as with the reference's subfiles.  The shards are the JAX
package's for the same host count, seed and batch.

A real run starts one process per rank, each with `init_distributed(
"host:port", n_hosts, host_id)`; without a coordinator one process emulates
the ranks (the tests' mode).

The process group is gloo's, on the host.  Every value the ranks exchange
(accept counts, the metagenome's per-species bases) is needed on the host
anyway, for numbering and for the species assignment, so nothing is gained
by moving it through the card; and NCCL refuses two ranks on one card,
which is how a one-card machine runs a two-rank job.
"""

from __future__ import annotations

import atexit
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..sim.output import report_progress
from .mesh import HostGroup, shard_sim_batch_numbered

# how long a rank waits for the others at the rendezvous and at every
# exchange before it fails (a rank that died must not hang the rest)
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the gloo process group at ``tcp://<coordinator>`` (host:port of
    rank 0's process group) as rank `process_id` of `num_processes`.  A
    no-op for one process; a second call in the same process (the
    metagenome joins once per sample) keeps the group it joined."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != num_processes or dist.get_rank() != process_id:
            raise ValueError("this process already joined another process group")
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    # leave the group before the interpreter shuts down: gloo's threads
    # destroyed at exit abort the process
    atexit.register(_leave)


def _leave() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device, host_id: int) -> torch.device:
    """The device of rank `host_id`: with a plain "cuda", card host_id
    modulo the machine's cards; any other device as given.  A card is made
    the calling thread's current one, so that every call that defaults to
    the current card (synchronisation, events, memory statistics, the card
    a kernel launcher launches from) is the rank's own."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        if dev.index is None:
            dev = torch.device("cuda", host_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _check_batch(batch: int, n_hosts: int) -> None:
    if batch % n_hosts:
        raise ValueError(f"batch {batch} not divisible by {n_hosts} devices")


def _run_numbered(sim, group: HostGroup, n_reads: int, writer, step, lane_args=None,
                  after=None) -> int:
    """The ranks' accept loop: until the GLOBAL accepted count reaches
    n_reads, run the next batch of slots through `step` (with
    ``lane_args(slots)`` when given, then ``after(reduced)``) and write this
    rank's accepted lanes at their global numbers.  Returns the number of
    reads written BY THIS RANK.

    Each batch's step (its shard, the fetch of its count and the exchange)
    and its write are the spans `dispatch` and `emit`, both carrying the
    batch's first slot, as in `genome_mode.run_prefetched`."""
    written = 0
    prior = 0  # global accepted before the current batch
    slot_start = 0
    B = sim.batch
    while prior < n_reads:
        slots = np.arange(slot_start, slot_start + B, dtype=np.int64)
        with tracing.span("dispatch", slot_start):
            res = step(slots, *(lane_args(slots) if lane_args is not None else ()))
            tracing.count("batches.dispatched")
        out, offsets, total = res[:3]
        start = prior + int(offsets[group.host_id])
        lanes = np.nonzero(writer.accepted(sim, out))[0][: max(0, n_reads - start)]
        if len(lanes):
            with tracing.span("emit", slot_start):
                written += writer.write_batch(sim, out, start, n_reads, lanes=lanes, start=start)
        slot_start += B
        if after is not None:
            after(res[3])
        prev = prior
        prior += total
        if group.host_id == 0:
            report_progress(prev, min(prior, n_reads))
    return written


class MultiHostModeRunner:
    """Multi-host runner of the simulators that dispatch a batch per slot
    range and whose writers emit from it: genome, chimeric genome, the
    unaligned pass (its simulator keys the slots off STREAM_UNALIGNED) and
    the transcriptome.  `dispatch_kw` goes to ``sim.dispatcher``: genome
    ranks pass ``full_events=True``, the full event budget, because rescued
    lanes could not be spliced into the sharded numbering and the
    full-budget program gives the lanes the single-host lean+rescue path
    gives.  Each rank runs its shard as its own call, so a chimeric batch's
    segment-major event rows (``ev_row = s*B + lane``) are laid out for the
    shard's own B/H lanes, where the writer looks for them."""

    def __init__(self, sim, n_hosts: int, host_id: int, **dispatch_kw):
        _check_batch(sim.batch, n_hosts)
        self.sim = sim
        self.group = HostGroup(n_hosts, host_id)
        self.dispatch_kw = dispatch_kw

    def run(self, n_reads: int, writer, seed: int = 0) -> int:
        """Simulate until the GLOBAL accepted count reaches n_reads; this
        rank writes only its own lanes.  Returns the reads written by it."""
        sim = self.sim
        step = shard_sim_batch_numbered(sim.dispatcher(seed, **self.dispatch_kw), self.group,
                                        count=lambda h: int(writer.accepted(sim, h).sum()))
        return _run_numbered(sim, self.group, n_reads, writer, step)


class MultiHostMetagenomeRunner:
    """Metagenome multi-host runner.

    The species-quota assignment (assign_species_batch) is sequential host
    state: every rank draws phase A for the FULL slot block and assigns the
    species identically (the same host RNG), runs its shard with its rows of
    the species, and the per-species accepted bases of every rank's
    accepted lanes are summed over the ranks, so all of them advance the
    same quota state (the writer's own feedback is off).
    """

    def __init__(self, sim, n_hosts: int, host_id: int):
        _check_batch(sim.batch, n_hosts)
        self.sim = sim
        self.group = HostGroup(n_hosts, host_id)

    def run(self, n_reads: int, writer, seed: int = 0) -> int:
        from ..ops import rng
        from ..sim.run_metagenome import assign_species_batch

        sim = self.sim
        base = rng.base_key(seed, rng.STREAM_ALIGNED, device=sim.device)
        rng_py = np.random.default_rng(np.random.SeedSequence([seed, 0xA55]))
        writer.species_bases = None  # the quota feedback comes from the ranks' sum
        n_species = len(sim.mset.species_names)

        def bases(h):
            lanes = np.nonzero(writer.accepted(sim, h))[0]
            return writer.species_bases_of(sim, h, lanes, n_species)

        step = shard_sim_batch_numbered(sim.dispatcher(seed), self.group,
                                        count=lambda h: int(writer.accepted(sim, h).sum()),
                                        reduce=bases)

        def species_of(slots):
            n_seg, m_ref = sim._phase_a(base, slots)
            return (assign_species_batch(m_ref, n_seg, sim.current_bases, sim.abun,
                                         sim.abun_inflated, rng_py),)

        def advance(summed):
            sim.current_bases = sim.current_bases + summed.astype(np.float64)

        return _run_numbered(sim, self.group, n_reads, writer, step, species_of, advance)


def merge_host_shards(out_path: str, shard_paths, header: str = "") -> None:
    """Concatenate per-host shard files (reference: simulator.py:1626-1639)."""
    from ..sim.output import merge_files

    merge_files(out_path, list(shard_paths), header=header)
