"""The metagenome cell on the CPU at a tiny size: the port (device="cpu")
against the plain reference of gpubench/reference/metagenome.py, and two
faults in the species feedback that the check has to catch, each planted in
the program under a whole run.  A job runs on the same simulators as the
warm-up job before it, so the species quotas of a reused simulator are
checked too."""

import numpy as np

from gpubench.harness import bench

from .conftest import tiny_sizes

CELL = "zymo_even_meta.chimeric"
SEED = 2**34 + 11  # past 32 bits, as a run's seed may be


def tiny_run(seed=SEED):
    _, config, _ = bench.cell_parts(CELL)
    return bench.run(CELL, seed, 0.5, False, device="cpu", sizes=tiny_sizes(config),
                     log=lambda m: None)


def test_cell_reads_correct():
    result, record = tiny_run()
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    kept = [v["record"] for j in record.jobs for (p, _), v in j["kept"].items()
            if p == "aligned"]
    names = [r.split(b"\n", 1)[0] for r in kept]
    # chimeric reads of two species or more, with their gap components, are among those checked
    assert any(b";gap_" in n for n in names)
    assert any(len({c.split(b"-", 1)[0] for c in n[1:].split(b";") if not c.startswith(b"gap_")})
               > 1 for n in names)


def test_fault_one_segment_species_swapped_is_caught(monkeypatch):
    """The first batch of every job dispatched with its first read's first
    segment in the next species: the bases go to another species' quota, and
    the packing of every later batch moves."""
    from nanosim_tpu_torch.sim.run_metagenome import MetagenomeSimulator

    dispatcher = MetagenomeSimulator.dispatcher

    def swapped(self, seed):
        dispatch = dispatcher(self, seed)

        def call(slots, species):
            if int(slots[0]) == 0:
                species = np.array(species)
                species[0, 0] = (species[0, 0] + 1) % len(self.abun)
            return dispatch(slots, species)

        return call

    monkeypatch.setattr(MetagenomeSimulator, "dispatcher", swapped)
    result, _ = tiny_run()
    assert not result["correct"]
    assert result["checks"]["mismatched_reads"]["value"] > 0


def test_fault_quota_feedback_skipped_for_one_batch_is_caught(monkeypatch):
    """The accepted reads of each job's first batch never reach the species
    quotas."""
    from nanosim_tpu_torch.sim import output

    advance = output.ChimericBatchWriter._advance_species_quota

    def skip_first(self, d, lanes):
        if getattr(self, "_skipped", False):
            return advance(self, d, lanes)
        self._skipped = True

    monkeypatch.setattr(output.ChimericBatchWriter, "_advance_species_quota", skip_first)
    result, _ = tiny_run()
    assert not result["correct"]
    assert result["checks"]["mismatched_reads"]["value"] > 0


def test_fault_quotas_kept_from_the_run_before_are_caught(monkeypatch):
    """A `run()` that leaves the run before's bases in the species quotas:
    the cell drives one simulator job after job, so every job after the
    warm-up packs against the wrong totals."""
    from nanosim_tpu_torch.sim.run_metagenome import MetagenomeSimulator

    def get(self):
        return self.__dict__["_bases"]

    def keep_first(self, bases):  # a run's fresh zeros never replace the totals
        self.__dict__.setdefault("_bases", bases)

    monkeypatch.setattr(MetagenomeSimulator, "current_bases", property(get, keep_first),
                        raising=False)
    result, _ = tiny_run()
    assert not result["correct"]
    assert result["checks"]["mismatched_reads"]["value"] > 0


def _buffers(fastq: bool):
    """A batch's FASTQ (or FASTA) records and log rows, names that hold the
    regular expressions' own characters and names that begin other names."""
    rng = np.random.default_rng(7)
    names = [f"S.p+({i % 3})-chr_{i * 7}_aligned_{i}_F_1_{int(rng.integers(9, 99))}_2"
             for i in range(40)] + ["x_aligned_4", "x_aligned_40", "x_aligned_4_0"]
    recs, rows, offs, fracs = [], [], [], []
    at = lo = 0
    for n in names:
        seq = bytes(rng.choice(list(b"ACGT"), int(rng.integers(1, 60))))
        rec = (b"@" if fastq else b">") + n.encode() + b"\n" + seq + b"\n"
        rec += b"+\n" + bytes(len(seq) * b"@") + b"\n" if fastq else b""
        recs.append(rec)
        offs.append(at)
        at += len(rec)
        fracs.append(lo)
        block = b"".join(n.encode() + b"\t%d\tmis\t1\tA\tC\n" % j
                         for j in range(int(rng.integers(0, 30))))
        rows.append(block)
        lo += len(block)
    log = b"".join(rows)
    return names, b"".join(recs), offs, log, [f / max(lo, 1) for f in fracs]


def test_literal_sink_finds_what_the_sink_finds():
    """literal_sink's searches against sink.py's regular expressions on
    every record and log block, at right and wrong offsets and estimates,
    and on names that are not there."""
    from gpubench.harness import literal_sink, sink

    for fastq in (True, False):
        names, fx, offs, log, fracs = _buffers(fastq)
        mv, lmv = memoryview(fx), memoryview(log)
        for n, off, frac in zip(names + ["absent_1"], offs + [0], fracs + [0.5]):
            for o in (off, off + 1, 0, len(fx) - 1, -1):
                assert literal_sink.record_at(mv, n, o) == sink._record_at(mv, n, o)
            for f in (frac, 0.0, 0.99, frac + 0.5):
                assert literal_sink.rows_of(lmv, n, f) == sink._rows_of(lmv, n, f)
            if n in names[:-3]:
                assert literal_sink.record_at(mv, n, 0) is not None
        for big in (sink.BLOCK_MAX // 4, sink.BLOCK_MAX + 3):  # blocks past BLOCK_MAX's reach
            pad = b"pad\t" + b"z" * big + b"\n"
            for buf in (memoryview(pad + log), memoryview(log + pad + log)):
                for n, f in zip(names[::5], fracs[::5]):
                    assert literal_sink.rows_of(buf, n, f) == sink._rows_of(buf, n, f)


def test_literal_sink_keeps_the_capture_of_the_sink():
    """Both sinks, handed the same writes in pieces, keep the same records
    and leave the same records waiting."""
    from gpubench.harness import literal_sink, sink

    names, fx, offs, log, fracs = _buffers(True)
    kept = []
    for cls in (sink.Sink, literal_sink.LiteralSink):
        cap = sink.Capture()
        for i in (0, 5, 17, 41):
            cap.want("aligned", i, names[i], offs[i] - offs[17] * (i > 17), fracs[i], True)
        cap.want("aligned", 99, "absent_1", 0, 0.0, True)
        fs, ls = cls(cap, "fastx"), cls(cap, "log")
        cut, lcut = offs[17], len(log) // 2
        for part in (fx[:cut], fx[cut:]):
            fs.write(part)
        for part in (log[:lcut], log[lcut:]):
            ls.write(part)
        assert fs.bytes == len(fx) and ls.bytes == len(log)
        kept.append((cap.kept, cap._fastx, cap._log))
    assert kept[0] == kept[1]
    assert kept[1][0]["aligned", 5]["record"] is not None
