"""Characterization stage: fit statistical models from real read alignments.

The reference (`read_analysis.py` + helpers) reads BAM via pysam and MAF
text; this implementation parses SAM text directly (and MAF), so the
alignment step asks minimap2 for SAM output instead of piping through
samtools.  All model files are written in the exact reference formats
(SURVEY.md §2.1) but the length KDEs (`*.pkl`): those are plain pickles of
the same data and bandwidth (profiles/kde.py), which this package's and the
JAX package's loaders read and the upstream simulator does not.
"""
