"""index_build_s: the benchmark's clock around the stage's constructor in
set-up (StrainDetector, MultiStrainDetector or StrainIndex.from_fasta)."""


def read(r):
    return r["index_build_s"]
