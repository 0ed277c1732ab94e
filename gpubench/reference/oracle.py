"""The plain reference of `simulate genome`: the reads that given slots
produce, worked out on the CPU from the benchmark's own FASTA and model
directory.

It loads both with its own frozen loaders, builds its own tables, and runs
the frozen plain batch programs on the slots it is asked about, at the
rescue-grade budget: a lane is valid exactly when the program emits it, and
its record is the bytes the program must write.  Nothing of the program is
imported or read, but the outputs it is asked to judge.

`uniforms="bfloat16"` is the control: every float32 uniform the draws start
from is rounded to bfloat16, the precision below the model's float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import extract, records, rng
from .bundles import build_tables
from .chimeric_mode import chimeric_batch, chimeric_plan
from .genome import PackedGenome
from .genome_mode import aligned_plan, genome_batch
from .profile import load_profile
from .unaligned_mode import unaligned_batch, unaligned_plan

CHUNK_LANES = 128  # lanes a reference call: its [lanes, l_out] int64 draws stay in memory
_BF16_BELOW_ONE = 0.99609375  # the largest bfloat16 below 1


@dataclasses.dataclass
class Lane:
    """One slot's outcome: whether the program must emit it, and what it
    must write for it under a given read index."""

    valid: bool
    render: Optional[callable]  # idx -> (record bytes, log bytes or None)


@contextlib.contextmanager
def _uniform_precision(uniforms: str):
    if uniforms == "float32":
        yield
        return
    if uniforms != "bfloat16":
        raise ValueError(f"uniforms must be float32 or bfloat16, not {uniforms!r}")
    plain = rng._bits_to_uniform

    def rounded(bits):
        u = plain(bits).to(torch.bfloat16).to(torch.float32)
        return torch.clamp(u, max=_BF16_BELOW_ONE)

    rng._bits_to_uniform = rounded
    try:
        yield
    finally:
        rng._bits_to_uniform = plain


class Reference:
    """The reference of one configuration and traffic mix."""

    def __init__(self, fasta: str, model_prefix: str, *, circular: bool, fastq: bool,
                 kmer_bias: Optional[int] = None, chimeric: bool = False, min_len: int = 50,
                 uniforms: str = "float32"):
        torch.set_num_threads(min(torch.get_num_threads(), 8))
        self.genome = PackedGenome.from_fasta(fasta, dna_type="circular" if circular else "linear")
        self.gdev = extract.GenomeDevice.from_packed(self.genome, "cpu")
        self.profile = load_profile(model_prefix, mode="genome", fastq=fastq, chimeric=chimeric,
                                    homopolymer=kmer_bias is not None)
        self.tables = build_tables(self.profile, "cpu")
        self.fastq = fastq
        self.kmer_bias = kmer_bias
        self.uniforms = uniforms
        self.chimeric = chimeric
        plan = chimeric_plan if chimeric else aligned_plan
        self.aligned_kw = plan(self.profile, self.genome, min_len=min_len, kmer_bias=kmer_bias,
                               fastq=fastq, circular_dna=circular)
        self.unaligned_kw = unaligned_plan(self.profile, self.genome, min_len=min_len,
                                           fastq=fastq, circular_dna=circular)

    def _batches(self, program, stream: int, seed: int, slots, kw):
        base = rng.base_key(seed, stream, device="cpu")
        slots = np.asarray(slots, np.int64)
        with torch.no_grad(), _uniform_precision(self.uniforms):
            for i in range(0, len(slots), CHUNK_LANES):
                ids = torch.as_tensor(slots[i:i + CHUNK_LANES])
                yield program(base, ids, self.gdev, self.tables, **kw)

    def aligned(self, seed: int, slots) -> list:
        """The aligned pass's lanes at these slots."""
        lanes = []
        program = chimeric_batch if self.chimeric else genome_batch
        render = self._chimeric_render if self.chimeric else self._aligned_render
        for out in self._batches(program, rng.STREAM_ALIGNED, seed, slots, self.aligned_kw):
            o = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in out._asdict().items()}
            for i in range(len(o["valid"])):
                lanes.append(Lane(bool(o["valid"][i]), render(o, i) if o["valid"][i] else None))
        return lanes

    def _aligned_render(self, o: dict, i: int):
        g = self.genome
        chrom, pos, rev = int(o["chrom"][i]), int(o["local_pos"][i]), bool(o["is_reversed"][i])
        head, tail, total = int(o["head"][i]), int(o["tail"][i]), int(o["total_len"][i])
        middle_ref, l_new = int(o["middle_ref"][i]), int(o["l_new"][i])
        read = o["read"][i].copy()
        quals = o["quals"][i].copy() if self.fastq else None
        n = int(o["ev_valid"][i].sum())
        events = (o["ev_pos2x"][i, :n].copy(), o["ev_type"][i, :n].copy(),
                  o["ev_len"][i, :n].copy())
        if self.kmer_bias is not None:
            middle = o["read_prehp"][i].copy()  # the pass-1 middle, before resizing
        else:
            middle = records.forward_middle(read, total, head, l_new, rev)

        def render(idx: int):
            name = records.aligned_name(g.names[chrom], pos, idx, rev, head, middle_ref, tail)
            rec = records.fastx_record(name, read[:total],
                                       quals[:total] if self.fastq else None, self.fastq)
            return rec, records.log_rows(name, *events, middle, g, chrom, pos)

        return render

    def _chimeric_render(self, o: dict, i: int):
        g = self.genome
        B = len(o["valid"])
        ns = int(o["n_seg"][i])
        chrom = [int(c) for c in o["chrom"][i, :ns]]
        pos = [int(p) for p in o["local_pos"][i, :ns]]
        mids = [int(m) for m in o["seg_middle_ref"][i, :ns]]
        rev = bool(o["is_reversed"][i])
        head, tail, total = int(o["head"][i]), int(o["tail"][i]), int(o["total_len"][i])
        read = o["read"][i, :total].copy()
        quals = o["quals"][i, :total].copy() if self.fastq else None
        segs = []
        for s in range(ns):
            row, n = s * B + i, int(o["n_events"][i, s])
            segs.append((o["ev_pos2x"][row, :n].copy(), o["ev_type"][row, :n].copy(),
                         o["ev_len"][row, :n].copy(), o["seg_read_prehp"][row].copy()))
        comps = ";".join(f"{g.names[c]}_{p}" for c, p in zip(chrom, pos))

        def render(idx: int):
            name = (comps + f"_aligned_{idx}" + ("_chimeric" if ns > 1 else "")
                    + ("_R" if rev else "_F") + f"_{head}_{';'.join(map(str, mids))}_{tail}")
            rec = records.fastx_record(name, read, quals, self.fastq)
            log = b"".join(records.log_rows(name, *segs[s][:3], segs[s][3], g, chrom[s], pos[s])
                           for s in range(ns))
            return rec, log

        return render

    def unaligned(self, seed: int, slots) -> list:
        """The unaligned pass's lanes at these slots."""
        lanes = []
        g = self.genome
        for out in self._batches(unaligned_batch, rng.STREAM_UNALIGNED, seed, slots,
                                 self.unaligned_kw):
            o = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in out._asdict().items()}
            ok = o["valid"] & ~o["capacity_overflow"]
            for i in range(len(ok)):
                if not ok[i]:
                    lanes.append(Lane(False, None))
                    continue
                chrom, pos = int(o["chrom"][i]), int(o["local_pos"][i])
                rev, middle_ref, l_new = bool(o["is_reversed"][i]), int(o["middle_ref"][i]), \
                    int(o["l_new"][i])
                read = o["read"][i, :l_new].copy()
                quals = o["quals"][i, :l_new].copy() if self.fastq else None

                def render(idx, chrom=chrom, pos=pos, rev=rev, middle_ref=middle_ref, read=read,
                           quals=quals):
                    name = records.unaligned_name(g.names[chrom], pos, idx, rev, middle_ref)
                    return records.fastx_record(name, read, quals, self.fastq), None

                lanes.append(Lane(True, render))
        return lanes
