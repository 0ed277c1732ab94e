"""Top-level model-directory loader.

`load_profile` is the equivalent of the reference's `read_profile`
(simulator.py:244-591) minus reference-sequence reading (see
`io.genome`), returning a typed :class:`ReadProfile` instead of
module globals.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from . import ecdf, error_model, kde


@dataclasses.dataclass
class ReadProfile:
    """Everything a simulation run samples from (the model directory)."""

    strandness_rate: float
    aligned_rate: Optional[float]  # None == '100%'

    # error models (absent in perfect mode)
    mix_params: Optional[error_model.MixtureParams] = None
    trans_error: Optional[np.ndarray] = None  # [7, 3]
    first_match: Optional[ecdf.EcdfTable] = None
    match_markov: Optional[ecdf.EcdfTable] = None

    # length models
    kde_aligned: Optional[kde.KdeModel] = None
    kde_ht: Optional[kde.KdeModel] = None  # log10(x+1) space
    kde_ht_ratio: Optional[kde.KdeModel] = None
    kde_unaligned: Optional[kde.KdeModel] = None

    # chimeric
    segment_mean: Optional[float] = None
    abun_inflation: Optional[float] = None
    kde_gap: Optional[kde.KdeModel] = None  # log10(x+1) space

    # fastq base qualities
    base_quals: Optional[dict] = None

    # homopolymers
    hp_params: Optional[error_model.HomopolymerParams] = None



def split_aligned_unaligned(number_list, aligned_rate, perfect: bool):
    """Per-sample (aligned, unaligned) read counts (simulator.py:465-467,
    535-542)."""
    if perfect:
        return list(number_list), [0] * len(number_list)
    if aligned_rate is None:
        aligned = list(number_list)
    else:
        aligned = [int(round(x * aligned_rate / (aligned_rate + 1))) for x in number_list]
    unaligned = [x - y for x, y in zip(number_list, aligned)]
    return aligned, unaligned


def load_profile(
    model_prefix: str,
    mode: str = "genome",
    perfect: bool = False,
    chimeric: bool = False,
    homopolymer: bool = False,
    fastq: bool = False,
    strandness: Optional[float] = None,
    need_unaligned: bool = True,
) -> ReadProfile:
    """Load a model directory with the same conditional structure as the
    reference's read_profile (simulator.py:244-591)."""

    if strandness is None:
        strandness_rate = error_model.read_strandness(model_prefix + "_strandness_rate")
    else:
        strandness_rate = strandness

    p = ReadProfile(strandness_rate=strandness_rate, aligned_rate=None)

    if not perfect:
        p.mix_params = error_model.read_model_profile(model_prefix + "_model_profile")
        p.trans_error = error_model.read_error_markov(model_prefix + "_error_markov_model")
        p.first_match = ecdf.read_ecdf_file(model_prefix + "_first_match.hist")
        p.match_markov = ecdf.read_ecdf_file(model_prefix + "_match_markov_model")
        p.aligned_rate = error_model.read_alignment_rate(model_prefix + "_reads_alignment_rate")
        if homopolymer:
            p.hp_params = error_model.read_homopolymer_params(
                model_prefix + "_hp_lengths_model_parameters.tsv"
            )
        if need_unaligned and p.aligned_rate is not None and os.path.exists(
            model_prefix + "_unaligned_length.pkl"
        ):
            p.kde_unaligned = kde.load_kde(model_prefix + "_unaligned_length.pkl")

    p.kde_ht = kde.load_kde(model_prefix + "_ht_length.pkl", log_transform=True)
    p.kde_ht_ratio = kde.load_kde(model_prefix + "_ht_ratio.pkl")

    # Perfect mode samples total read length; otherwise the aligned-region
    # length (simulator.py:559-567).
    if mode != "genome":
        raise ValueError("the reference covers genome mode")
    if perfect:
        p.kde_aligned = kde.load_kde(model_prefix + "_aligned_reads.pkl")
    else:
        p.kde_aligned = kde.load_kde(model_prefix + "_aligned_region.pkl")

    if chimeric:
        p.segment_mean, p.abun_inflation = error_model.read_chimeric_info(
            model_prefix + "_chimeric_info"
        )
        p.kde_gap = kde.load_kde(model_prefix + "_gap_length.pkl", log_transform=True)

    if fastq:
        p.base_quals = error_model.read_base_quality_params(
            model_prefix + "_base_qualities_model_parameters.tsv"
        )

    return p
