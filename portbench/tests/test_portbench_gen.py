"""The generator is deterministic by seed, and every seed gets the same sizes."""

import gzip
import os

import numpy as np

from conftest import TINY_COHORT, TINY_COHORT_TARGETS, TINY_PANEL, TINY_STRAIN

from pbcore import gen


def make(tmp_path, name, seed, cfg, mix):
    d = tmp_path / name
    d.mkdir()
    return gen.make_inputs(cfg, mix, seed, str(d)), d


def files(d):
    out = {}
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n), "rb") as f:
            out[n] = f.read()
    return out


def test_same_seed_same_files(tmp_path):
    mix = {**TINY_COHORT_TARGETS, **TINY_PANEL}
    a, da = make(tmp_path, "a", 2**40 + 3, TINY_COHORT, mix)
    b, db = make(tmp_path, "b", 2**40 + 3, TINY_COHORT, mix)
    fa, fb = files(da), files(db)
    assert fa.keys() == fb.keys()
    # the list files name the directory they are in
    assert all(fa[n].replace(str(da).encode(), b"") == fb[n].replace(str(db).encode(), b"")
               for n in fa)
    assert all(np.array_equal(x.reads1, y.reads1) for x, y in zip(a.samples, b.samples))


def test_other_seed_same_sizes(tmp_path):
    mix = {**TINY_COHORT_TARGETS, **TINY_PANEL}
    a, da = make(tmp_path, "a", 1, TINY_COHORT, mix)
    b, db = make(tmp_path, "b", 2, TINY_COHORT, mix)
    assert a.target_windows() == b.target_windows() and a.panel_windows() == b.panel_windows()
    assert [s.reads1.shape for s in a.samples] == [s.reads1.shape for s in b.samples]
    assert not np.array_equal(a.samples[0].reads1, b.samples[0].reads1)


def test_files_hold_the_arrays(tmp_path):
    """The FASTA.gz files say what the arrays the reference reads say."""
    inp, _ = make(tmp_path, "a", 9, TINY_STRAIN, dict(TINY_PANEL, samples=[
        {"type": "PE", "pairs": 50, "strain_fraction": 0.5}], warm_samples=[
        {"type": "SE", "reads": 5, "strain_fraction": 0.5}], insert=[300, 500], n_rate=0.01))
    s = inp.samples[0]
    for path, reads in ((s.f1, s.reads1), (s.f2, s.reads2)):
        lines = gzip.decompress(open(path, "rb").read()).split(b"\n")
        assert lines[1::2] == [gen.ASCII[r].tobytes() for r in reads]
    st = inp.strains[0]
    text = gzip.decompress(open(st.path, "rb").read()).split(b"\n")
    seqs = b"".join(t for t in text if not t.startswith(b">"))
    assert seqs == gen.ASCII[np.concatenate(st.contigs)].tobytes()
    assert (inp.panel.metagenomes[0][1] == 4).any()  # some N bases


def test_cohort_informative_sets_are_scrubbed(tmp_path):
    """In a cohort every strain's informative k-mers lie in its own genome
    and in no other strain's (the -C scrub), as many as the unscrubbed
    draw gives; one strain keeps the unscrubbed draw."""
    inp, _ = make(tmp_path, "a", 12, TINY_COHORT, TINY_COHORT_TARGETS)
    k = TINY_COHORT["k"]
    kmers = [np.unique(np.concatenate([gen.window_codes(c, k) for c in s.contigs]))
             for s in inp.strains]
    for s, st in enumerate(inp.strains):
        assert np.isin(st.informative, kmers[s]).all()
        for o in range(len(kmers)):
            if o != s:
                assert not np.isin(st.informative, kmers[o]).any()
    one, _ = make(tmp_path, "b", 12, dict(TINY_COHORT, strains=1), TINY_COHORT_TARGETS)
    assert one.strains[0].informative.size == inp.strains[0].informative.size
    assert np.isin(one.strains[0].informative, kmers[1]).mean() > 0.5
