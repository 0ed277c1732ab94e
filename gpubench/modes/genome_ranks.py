"""`simulate genome --num_hosts <n>` as the benchmark drives it: n ranks, one
process and one card a rank.

The deployment is NanoSim's own way of scaling a run (workers that each
simulate a share of the reads into private files, merged by concatenation,
simulator.py:1571-1672) as the port maps it: every rank walks the same global
slot schedule, runs its share of every batch, all-gathers its accept count
over gloo and writes its own reads at their global numbers
(nanosim_tpu_torch/parallel/).

Rank 0 is the harness's process, on card 0.  Once the inputs are made it
starts ranks 1..n-1 as processes of this module (`python -m
gpubench.modes.genome_ranks <rank>`), each of which sees every card, takes
its own through the program's `rank_device` and builds the simulators of
`modes/genome.py`; the ranks join the process group when all are built.  A
job is then the one-card cell's job with both passes run through
`MultiHostModeRunner`, on every rank at once: rank 0 sends each rank the
job's seed, sample and quota over the rank's standard input, runs its own
share, and reads back over the rank's standard output what the rank wrote
(its runs of read numbers and slots, its kept records, its bytes and its
`RUN_STATS` counts).  The union of the ranks' runs is the job's read index
to slot map that the check follows, so `correct` judges the four ranks'
merged output against the single-host reference.

Rank 0's dispatch, fetch and emit carry the benchmark's spans as in
`modes/genome.py`, and its group's collectives the span `exchange`; a
traced job traces rank 0 alone.  A rank that exits, or a rendezvous or job
that stalls for STALL_S, ends the run with the rank's last lines of
standard error.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
import weakref
from multiprocessing.connection import Connection

import numpy as np

from .genome import PASSES, GenomeMode, _mark, load_libraries, make_inputs, reference  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STALL_S = 120.0  # longest wait for a rank at the rendezvous, an exchange or a job's end
TAIL_BYTES = 4000  # of a failed rank's standard error, shown with the failure


def _log(msg: str):
    print(f"[genome_ranks] {msg}", file=sys.stderr, flush=True)


def _slot_map(runs) -> tuple:
    """(slots in read order, whether the runs' read numbers are gapless)
    of (first read number, slots) runs."""
    runs = sorted(runs, key=lambda r: r[0])
    slots = np.concatenate([r[1] for r in runs]) if runs else np.zeros(0, np.int64)
    nxt = 0
    for first, sl in runs:
        if first != nxt:
            return slots, False
        nxt = first + len(sl)
    return slots, True


class RankMode(GenomeMode):
    """One rank's program: the one-card cell's simulators on the rank's card,
    both passes run through the program's multi-rank runner once `join`ed."""

    def __init__(self, config: dict, traffic: dict, inputs: dict, *, device, host_id: int,
                 **kwargs):
        from nanosim_tpu_torch.parallel import rank_device

        self.n_ranks = int(config["ranks"])
        self.host_id = host_id
        self._job_writers = None
        super().__init__(config, traffic, inputs, device=rank_device(device, host_id), **kwargs)

    def _writers(self):
        self._job_writers = super()._writers()
        return self._job_writers

    def run_job(self, seed: int, wanted=None, quota=None) -> dict:
        try:
            return super().run_job(seed, wanted, quota)
        finally:
            # the wrappers GenomeMode puts on the job's writers and emitters
            # refer to their own objects and to this mode: a cycle that would
            # keep the mode, and so the ranks, alive until the collector runs
            if self._job_writers is not None:
                (_, _, writer), (_, uwriter) = self._job_writers
                for obj in (writer, writer._emitter, uwriter, uwriter._emitter):
                    vars(obj).clear()
                self._job_writers = None

    def join(self, coordinator: str):
        """Join the ranks' process group and run the passes through it."""
        from nanosim_tpu_torch.parallel import MultiHostModeRunner, init_distributed

        init_distributed(coordinator, self.n_ranks, self.host_id, timeout_s=STALL_S)
        for sim, kw in ((self.sim, {"full_events": True}), (self.usim, {})):
            runner = MultiHostModeRunner(sim, self.n_ranks, self.host_id, **kw)
            group = runner.group
            group.gather = self.spans.wrap("exchange", group.gather)
            group.sum = self.spans.wrap("exchange", group.sum)
            sim.run = runner.run


class _Rank:
    """A rank's process, sent its set-up and its jobs over its standard
    input and heard back from over its standard output; its standard error
    goes to a file."""

    def __init__(self, host_id: int, spec: dict, workdir: str):
        self.host_id = host_id
        self.err_path = os.path.join(workdir, f"rank{host_id}.stderr")
        to_rank, from_rank = os.pipe(), os.pipe()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        with open(self.err_path, "wb") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "gpubench.modes.genome_ranks", str(host_id)], cwd=ROOT,
                env=env, stdin=to_rank[0], stdout=from_rank[1], stderr=err)
        os.close(to_rank[0])
        os.close(from_rank[1])
        self.tx = Connection(to_rank[1], readable=False)
        self.rx = Connection(from_rank[0], writable=False)
        self.tx.send(spec)

    def send(self, msg):
        self.tx.send(msg)

    def receive(self, kind: str):
        """The rank's next message, which has to be `kind`; raises if the rank
        exits or sends nothing for STALL_S."""
        deadline = time.monotonic() + STALL_S
        while not self.rx.poll(0.25):
            if self.proc.poll() is not None:
                raise RuntimeError(f"rank {self.host_id} exited with code {self.proc.returncode}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"rank {self.host_id} sent no '{kind}' in {STALL_S:.0f} s")
        try:
            got, body = self.rx.recv()
        except EOFError:
            raise RuntimeError(f"rank {self.host_id} closed its pipe") from None
        if got != kind:
            raise RuntimeError(f"rank {self.host_id} sent '{got}', not '{kind}'")
        return body

    def tail(self) -> str:
        try:
            with open(self.err_path, "rb") as f:
                f.seek(max(0, os.path.getsize(self.err_path) - TAIL_BYTES))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def stop(self, wait_s: float):
        for conn in (self.tx, self.rx):
            conn.close()  # the rank reads the end of its input and leaves
        try:
            self.proc.wait(wait_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _stop(ranks, wait_s: float = 10.0):
    """Stop the ranks' processes and leave the process group."""
    for r in ranks:
        r.stop(wait_s)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RanksMode(RankMode):
    """Rank 0, in the harness's process, and the ranks it starts."""

    def __init__(self, config: dict, traffic: dict, inputs: dict, *, device, spans, capture,
                 job_reads: int, batch: int, clock=None):
        import torch

        t0 = time.perf_counter()
        coordinator = f"127.0.0.1:{_free_port()}"
        spec = {"config": config, "traffic": traffic, "inputs": inputs, "device": device,
                "job_reads": job_reads, "batch": batch, "coordinator": coordinator,
                "threads": torch.get_num_threads()}
        workdir = os.path.dirname(inputs["fasta"])
        self.ranks = []
        self._stopper = weakref.finalize(self, _stop, self.ranks)
        try:
            for h in range(1, int(config["ranks"])):
                self.ranks.append(_Rank(h, spec, workdir))
            super().__init__(config, traffic, inputs, device=device, host_id=0, spans=spans,
                             capture=capture, job_reads=job_reads, batch=batch, clock=clock)
            for r in self.ranks:
                ready = r.receive("ready")
                _log(f"rank {r.host_id} ready on {ready['device']} (current card "
                     f"{ready['current']}) {ready['seconds']:.3f} s after its start")
            self.join(coordinator)
        except BaseException as e:
            self._fail(e)
        _log(f"{len(self.ranks) + 1} ranks joined {time.perf_counter() - t0:.3f} s after the "
             f"first was started")
        _mark(clock, "ranks")

    def _fail(self, e: BaseException):
        """Stop every rank and raise, with the last lines of the ranks that
        exited (given a few seconds to show as exited)."""
        deadline = time.monotonic() + 5.0
        while (not any(r.proc.poll() is not None for r in self.ranks)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        dead = [r for r in self.ranks if r.proc.poll() is not None]
        for r in self.ranks:
            r.proc.kill()
        self._stopper()
        for r in dead:
            _log(f"rank {r.host_id} exited with code {r.proc.returncode}; its last lines:\n"
                 f"{r.tail()}")
        if dead:
            raise RuntimeError(
                f"rank(s) {[r.host_id for r in dead]} exited ({e.__class__.__name__}: {e}); "
                f"rank {dead[0].host_id}'s last lines:\n{dead[0].tail()[-1500:]}") from e
        raise e

    def run_job(self, seed: int, wanted=None, quota=None) -> dict:
        """One job on every rank; the index to slot map, kept records, bytes
        and counters of their union."""
        try:
            for r in self.ranks:
                r.send(("job", (seed, wanted, quota)))
            res = super().run_job(seed, wanted, quota)
            others = [r.receive("done") for r in self.ranks]
        except BaseException as e:
            self._fail(e)
        from nanosim_tpu_torch.sim.output import RUN_STATS

        slots = {}
        for p in PASSES:
            runs = list(self.written[p])
            for o in others:
                runs.extend(o["written"][p])
            slots[p], slots[p + ".contiguous"] = _slot_map(runs)
        longest = {p: max([self.longest[p]] + [tuple(o["longest"][p]) for o in others])[1]
                   for p in PASSES}
        for o in others:
            self.capture.kept.update(o["kept"])
            for k, v in o["stats"].items():
                setattr(RUN_STATS, k, getattr(RUN_STATS, k) + v)
        for r, o in zip(self.ranks, others):
            _log(f"rank {r.host_id} on {o['device']} (current card {o['current']}): "
                 f"{o['reads']} reads, peak {o['peak_mib']:.1f} MiB, K1 launches {o['k1']}")
        return {"slots": slots, "quota": res["quota"],
                "bytes": res["bytes"] + sum(o["bytes"] for o in others), "longest": longest}


Mode = RanksMode


def _device_info(mode) -> dict:
    import torch

    dev = mode.sim.device
    on_card = torch.device(dev).type == "cuda"
    return {"device": str(dev),
            "current": torch.cuda.current_device() if on_card else None,
            "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20 if on_card else 0.0}


def rank_main(host_id: int) -> int:
    """A rank's process: set-up from the first message on standard input,
    then a job a message until the input ends."""
    t0 = time.perf_counter()
    rx = Connection(os.dup(0), writable=False)
    tx = Connection(os.dup(1), readable=False)
    os.dup2(2, 1)  # the program's own output goes to standard error
    spec = rx.recv()
    import torch

    from nanosim_tpu_torch.ops import walk_cuda

    from ..harness.bench import _stats
    from ..harness.sink import Capture
    from ..harness.spans import Spans

    torch.set_num_threads(spec["threads"])
    capture = Capture()
    mode = RankMode(spec["config"], spec["traffic"], spec["inputs"], device=spec["device"],
                    host_id=host_id, spans=Spans(), capture=capture,
                    job_reads=spec["job_reads"], batch=spec["batch"])
    tx.send(("ready", {**_device_info(mode), "seconds": time.perf_counter() - t0}))
    mode.join(spec["coordinator"])
    jobs = 0
    while True:
        try:
            kind, (seed, wanted, quota) = rx.recv()
        except EOFError:
            return 0
        capture.reset()
        before = _stats()
        res = mode.run_job(seed, wanted, quota)
        after = _stats()
        tx.send(("done", {"written": mode.written, "kept": dict(capture.kept),
                          "bytes": res["bytes"], "longest": mode.longest,
                          "reads": sum(len(r[1]) for p in PASSES for r in mode.written[p]),
                          "stats": {k: after[k] - before[k] for k in after},
                          "k1": walk_cuda.aligned_steps.launches, **_device_info(mode)}))
        jobs += 1
        if jobs == 1 and torch.device(mode.sim.device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(mode.sim.device)  # after the warm-up, as rank 0


if __name__ == "__main__":
    sys.exit(rank_main(int(sys.argv[1])))
