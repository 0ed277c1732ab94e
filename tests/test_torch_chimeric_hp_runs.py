"""`simulate genome --chimeric -hp -k 6` runs of the port against the JAX
package, byte for byte, on circular and on linear DNA (both run the
read-emitting program; the log is composed in Python from the pre-resize
segments), and the C++ chimeric reconstruction (emit_chimeric_recon) against
its numpy spec.  The other whole chimeric runs are in
tests/test_torch_chimeric_runs.py.
"""

import os

import numpy as np
import pytest

from nanosim_tpu_torch.io.genome import PackedGenome as TGenome
from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import chimeric_mode as tchi
from nanosim_tpu_torch.sim import output as tout
from nanosim_tpu_torch.sim import reconstruct

from test_torch_common import (CHIMERIC_BATCH, CHIMERIC_SEED, assert_same_files, chimeric_share,
                               jax_chimeric_runs, make_chimeric_model, read_file,
                               torch_chimeric_run)

K = 6


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return make_chimeric_model(str(tmp_path_factory.mktemp("chihp")))


@pytest.fixture(scope="module")
def jax_runs(model):
    return jax_chimeric_runs(model)


@pytest.mark.parametrize("dna", ["circular", "linear"])
def test_chimeric_hp_run_byte_identical(model, jax_runs, dna):
    """`--chimeric -hp -k 6`: Route B with suppression and resizing on the
    segment lanes, the log composed in Python from the pre-resize segments."""
    tag = f"hp_{dna}"
    b = torch_chimeric_run(model, tag, True, dna=dna, kmer_bias=K)
    assert_same_files(jax_runs(tag, True, dna=dna, kmer_bias=K), b, fastq=True)
    assert chimeric_share(b, True)[0] >= 20
    # not vacuous: -hp changed the reads and the log of the plain run
    plain = torch_chimeric_run(model, f"plain_{dna}", True, dna=dna)
    for suf in ("_aligned_reads.fastq", "_aligned_error_profile"):
        assert read_file(b + suf) != read_file(plain + suf), suf


def test_native_chimeric_emitter_matches_numpy_spec(model):
    """The C++ chimeric reconstruction (emit_chimeric_recon) equals
    sim/reconstruct.reconstruct_chimeric_lane on every accepted lane of a
    run: reads and FASTQ qualities, from the same replayed part events."""
    d, prefix, lin, _ = model
    genome = TGenome.from_fasta(lin)
    prof = tprofile.load_profile(prefix, mode="genome", fastq=True, chimeric=True)
    sim = tchi.ChimericGenomeSimulator(genome, prof, fastq=True, batch=CHIMERIC_BATCH, device="cpu")
    fw = tout.FastxWriter(os.path.join(d, "spec_aligned_reads.fastq"), True)
    writer = tout.ChimericBatchWriter(fw, None)
    calls = []
    inner = writer._emitter.emit_chimeric_recon

    def capture(**kw):
        fx, err = inner(**kw)
        calls.append((kw, bytes(fx)))
        return fx, err

    writer._emitter.emit_chimeric_recon = capture
    assert sim.run(100, writer, seed=CHIMERIC_SEED) == 100
    fw.close()
    assert len(calls) >= 2
    S = sim.s_max
    G = S - 1
    qt = (sim.tables.qual.breaks.numpy(), sim.tables.qual.vals.numpy())

    def decode(w):  # the replayers' words: pos2x | len << 17 | type << 30
        return ((w & np.uint32(0x1FFFF)).astype(np.int64), (w >> np.uint32(30)).astype(np.int64),
                ((w >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64))

    n_multi = 0
    for kw, got in calls:
        want = []
        for r, slot in enumerate(kw["slots"]):
            ns = int(kw["n_seg"][r])
            n_multi += ns > 1
            segs, gaps = [], []
            for s in range(ns):
                i = r * S + s
                o, ne = int(kw["seg_ev_off"][i]), int(kw["seg_n_ev"][i])
                segs.append((int(kw["seg_part_off"][i]), int(kw["seg_lnew"][i]),
                             int(kw["seg_mid"][i]), int(kw["seg_goff"][i]),
                             int(kw["seg_spos"][i]), decode(kw["seg_ev_flat"][o : o + ne])))
            for gi in range(ns - 1):
                i = r * G + gi
                o, nst = int(kw["gap_ev_off"][i]), int(kw["gap_n_steps"][i])
                gaps.append((int(kw["gap_part_off"][i]), int(kw["gap_lnew"][i]),
                             int(kw["gap_mid"][i]), int(kw["gap_goff"][i]),
                             int(kw["gap_spos"][i]), decode(kw["gap_ev_flat"][o : o + nst])))
            rec = dict(head=int(kw["head"][r]), tail=int(kw["tail"][r]),
                       total=int(kw["total"][r]), rev=bool(kw["rev"][r]), n_seg=ns,
                       segs=segs, gaps=gaps)
            read, quals, _ = reconstruct.reconstruct_chimeric_lane(
                genome, CHIMERIC_SEED, trng.STREAM_ALIGNED, int(slot), rec, sim.ht_cap,
                qual_table=qt)
            want.append(b"@%s\n%s\n+\n%s\n" % (kw["names"][r].encode(), read.tobytes(),
                                               quals.tobytes()))
        assert got == b"".join(want)
    assert n_multi >= 20
