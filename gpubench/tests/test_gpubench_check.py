"""The check that decides `correct`, at a tiny size on the CPU: the port
(device="cpu") against the frozen reference in every cell, the bfloat16
control, and the faults the check has to catch, each planted in the
program under a whole run."""

import numpy as np
import pytest

from gpubench import control as control_mod
from gpubench.harness import bench

from .conftest import tiny_sizes

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]
SEED = 2**33 + 7  # past 32 bits, as a run's seed may be


def tiny_run(cell, seed=SEED):
    _, config, _ = bench.cell_parts(cell)
    return bench.run(cell, seed, 0.5, False, device="cpu", sizes=tiny_sizes(config),
                     log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_port_equals_reference(cell):
    result, record = tiny_run(cell)
    checks = result["checks"]
    assert result["correct"], checks
    assert all(c["value"] == 0 for c in checks.values())
    assert result["attempted"] == sum(sum(j["quota"].values()) for j in record.jobs)
    kept = sum(len(j["kept"]) for j in record.jobs)
    assert kept >= 12 + 4  # the sample of both passes, and their longest reads
    assert {"reads_per_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_is_not_correct(cell):
    _, config, _ = bench.cell_parts(cell)
    r = control_mod.control(cell, SEED + 1, 0.5, device="cpu", sizes=tiny_sizes(config),
                            log=lambda m: None)
    assert r["program_correct"]
    assert not r["control_correct"]
    assert r["control"]["mismatched_reads"]["value"] >= r["checked"] // 2


def _altered(method):
    """An emitter call whose reads come out with their first base changed."""

    def emit(*args, **kwargs):
        out = method(*args, **kwargs)
        fastx = out[0] if isinstance(out, tuple) else out
        data = bytearray(bytes(fastx))
        lines = data.split(b"\n")
        for i in range(1, len(lines), 4):
            if lines[i]:
                lines[i][0:1] = b"C" if lines[i][0:1] != b"C" else b"G"
        new = memoryview(bytes(b"\n".join(lines)))
        return (new, *out[1:]) if isinstance(out, tuple) else new

    return emit


def test_fault_altered_read_is_caught(monkeypatch):
    from nanosim_tpu_torch.io import native

    for m in ("emit_recon", "emit_recon_unaligned"):
        monkeypatch.setattr(native.NativeEmitter, m, _altered(getattr(native.NativeEmitter, m)))
    result, _ = tiny_run("human_chr21_dna.fastq")
    assert not result["correct"]
    assert result["checks"]["mismatched_reads"]["value"] > 0


def test_fault_half_the_batch_left_out_is_caught(monkeypatch):
    from nanosim_tpu_torch.sim import output

    write_run = output.GenomeBatchWriter.write_run

    def half(self, sim, cb, lanes, accepted_so_far):
        return write_run(self, sim, cb, lanes[: (len(lanes) + 1) // 2], accepted_so_far)

    monkeypatch.setattr(output.GenomeBatchWriter, "write_run", half)
    result, _ = tiny_run("human_chr21_dna.fastq")
    assert not result["correct"]
    assert result["checks"]["missed_reads"]["value"] > 0


def test_fault_batch_state_unchanged_is_caught(monkeypatch):
    """Every batch dispatched on the first batch's slots: the accept loop's
    state does not move on."""
    from nanosim_tpu_torch.sim import genome_mode

    dispatcher = genome_mode.GenomeSimulator.dispatcher

    def stuck(self, seed, *args, **kwargs):
        dispatch = dispatcher(self, seed, *args, **kwargs)
        first = []

        def again(slots):
            if not first:
                first.append(np.asarray(slots).copy())
            return dispatch(first[0])

        return again

    monkeypatch.setattr(genome_mode.GenomeSimulator, "dispatcher", stuck)
    result, _ = tiny_run("human_chr21_dna.fastq")
    assert not result["correct"]
    assert result["checks"]["order_faults"]["value"] > 0
