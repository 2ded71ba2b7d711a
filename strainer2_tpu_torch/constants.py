"""Behaviour-defining constants of the port: a copy of the ones it uses from
``strainer2_tpu.constants`` (tests/test_torch_host.py pins each value).

k-mers are 2-bit packed MSB-first with A=0, C=1, G=2, T=3, so numeric order
of packed codes equals the lexicographic order of the ACGT strings.
"""

# Default k-mer length (reference src/kmer_scrub_count.c:39,
# src/strain_detect.c:78).
DEFAULT_K = 31

# Maximum k of the 64-bit packed representation.
MAX_K = 32

# Code of any character that is not A/C/G/T, and of the padding and read
# separators in packed buffers, so windows crossing them are invalid.
INVALID_BASE = 4

# Count columns of the kmer_scrub_count table, which also name a
# checkpoint's count files (reference src/kmer_scrub_count.c:43).
COL_PANGENOME = 1
COL_METAGENOME = 2
COL_DRUG = 3

# strain_detect k-mer classes (reference src/strain_detect.c:17-18).
NON_INFORMATIVE_KMER = 1
INFORMATIVE_KMER = 2

# strain_detect pairing modes (reference src/strain_detect.c:19-21).
NOT_PAIRED_END = 0
IS_PAIRED_END = 1
IS_PAIRED_END_INTERLEAVE = 2

# Initial capacity of the reference's open-addressing hash; replaying its
# output row order needs it (reference src/genome_compare.h:20).
REFERENCE_HASH_INITIAL_CAPACITY = 8_000_000

# Fraction of informative k-mers the background filter tries to demote
# (reference src/strain_detect.c:82).
BACKGROUND_FRACTION_TO_REMOVE = 0.5
