"""The benchmark's own tests: on the CPU, at tiny sizes, with the port run
with device="cpu"; those marked `gpu` need the card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skipped with a reason where there is none)")


# one torch thread a worker: the plain walks run many small ops
@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY = {"genome_scale": None, "job_reads": 300, "batch": 64,
        "model": {"mean_read_len": 600.0, "sd_read_len": 200.0, "n_kde_points": 300,
                  "segment_mean": 1.9}}


def tiny_sizes(config: dict) -> dict:
    """Sizes at which a cell runs on the CPU in seconds: a genome of about
    90 kb, reads of about 600 bases, jobs of 300 reads, batches of 64."""
    total = sum(n for _, n in config["chromosomes"])
    return dict(TINY, genome_scale=90_000 / total)
