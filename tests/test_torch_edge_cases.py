"""The hostile-input cases of tests/test_edge_cases.py through the port's
readers and stages on the CPU: empty and sub-k targets, CRLF and
lowercase, a sub-k contig, an empty panel, unreadable inputs (with
STRAINER2_COUNT_THREADS 1 and 4), a truncated gzip, garbage between FASTQ
records, IUPAC letters in targets, multi-member gzip, a truncated FASTQ
quality, leading garbage and mixed FASTA/FASTQ.  The same inputs give the
same exit codes, totals and stderr lines as there; where a case reads a
file, the port's native reader and its pure-Python twin give the codes of
the JAX package's scan of the same file.  strain_detect's rows chosen by
the select kernel's plain version equal, byte for byte, the host emission
of the mesh route and the JAX package's, on SE, PE and PEI -B runs and on
a batch that passes the gate with zero rows."""

import gzip
import io
import os

import numpy as np
import pytest

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")
K = 31
R1 = "ACGTACGTACGTACGTACGTACGTACGTACGTACGT"
R2 = "TTGCACGTACGTACGTACGTACGTACGTACGTACGTACGA"


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


@pytest.fixture(autouse=True)
def _chdir(monkeypatch):
    monkeypatch.chdir(MINI)


# Small batches for the CPU runs (as tests/test_torch_fused.py): outputs do
# not depend on the batch geometry.
ROWS, ROW_LEN = 8, 1024


@pytest.fixture(autouse=True)
def _small_batches(monkeypatch):
    from dataclasses import dataclass

    from strainer2_tpu_torch.pipeline import detect, scrub_count

    @dataclass
    class SmallScrub(scrub_count.ScrubCountConfig):
        rows: int = ROWS
        row_len: int = ROW_LEN

    @dataclass
    class SmallDetect(detect.DetectConfig):
        rows: int = ROWS
        row_len: int = ROW_LEN

    monkeypatch.setattr(scrub_count, "ScrubCountConfig", SmallScrub)
    monkeypatch.setattr(detect, "DetectConfig", SmallDetect)


def _engine():
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    return TorchKmerEngine(K, device="cpu")


def _port_codes(monkeypatch, path: str, reader: str) -> np.ndarray:
    """The port's scan_file_codes of ``path`` through its native reader or,
    with the library reported missing, its pure-Python twin."""
    from strainer2_tpu_torch import native
    from strainer2_tpu_torch.index.build import scan_file_codes

    if reader == "native":
        assert native.available(), native.build_error
        return scan_file_codes(path, _engine(), ROWS, ROW_LEN)
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return scan_file_codes(path, _engine(), ROWS, ROW_LEN)


def _jax_codes(path: str) -> np.ndarray:
    from strainer2_tpu.index.build import scan_file_codes
    from strainer2_tpu.pipeline.engine import KmerEngine

    return scan_file_codes(path, KmerEngine(K))


def _oracle(*reads) -> np.ndarray:
    from tests.oracle import canonical_codes_of_seq

    return np.array([c for r in reads for v, c in canonical_codes_of_seq(r, K) if v],
                    dtype=np.uint64)


def _fastq(name: str, seq: str) -> str:
    return f"@{name}\n{seq}\n+\n" + "I" * len(seq) + "\n"


def _write_case(case: str, d) -> tuple[str, np.ndarray | None]:
    """A hostile file of tests/test_edge_cases.py and the codes that test
    expects of it (None: the JAX scan alone is the reference)."""
    f = d / case
    if case == "crlf_lowercase":
        seq = "acgtacgtacgtacgtacgtacgtacgtacgtacgtacgta"
        f.write_bytes(b">c1\r\n" + seq[:20].encode() + b"\r\n" + seq[20:].encode() + b"\r\n")
        return str(f), _oracle(seq.upper())
    if case == "truncated_gzip":
        rng = np.random.default_rng(5)
        alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
        reads = [alpha[rng.integers(0, 4, size=100)].tobytes().decode() for _ in range(50)]
        blob = gzip.compress("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)).encode())
        f.write_bytes(blob[: len(blob) // 2])
        return str(f), None
    if case == "garbage_between_fastq":
        f.write_bytes(_fastq("r1", R1).encode() + b"\x00\xff\x13garbage~~~\n"
                      + _fastq("r2", R2).encode())
        return str(f), _oracle(R1, R2)
    if case == "multimember_gzip":
        with gzip.open("data/strainA.fna.gz", "rb") as fh:
            text = fh.read()
        half = len(text) // 2
        f.write_bytes(gzip.compress(text[:half]) + gzip.compress(text[half:]))
        return str(f), _jax_codes("data/strainA.fna.gz")
    r2 = "TTTTACGTACGTACGTACGTACGTACGTACGTTTTT"
    if case == "fastq_cut_in_quality":  # kseq ends the file at the partial record
        f.write_text(_fastq("r1", R1) + f"@r2\n{r2}\n+\nIIIII")
        return str(f), _oracle(R1)
    if case == "fastq_cut_before_plus":  # the partial sequence is yielded as it is
        f.write_text(_fastq("r1", R1) + f"@r2\n{r2}")
        return str(f), _oracle(R1, r2)
    if case == "leading_garbage":
        f.write_bytes(b"\x00junk junk\n~~\n" + f">r1\n{R1}\n".encode())
        return str(f), _oracle(R1)
    if case == "no_marker":
        f.write_bytes(b"no markers here\nat all\n")
        return str(f), np.empty(0, dtype=np.uint64)
    assert case == "mixed_fasta_fastq"
    r2m, r3 = "TTGCACGTACGTACGTACGTACGTACGTACGTACGA", "GGGTACGTACGTACGTACGTACGTACGTACGTACCC"
    f.write_text(f">r1\n{R1}\n" + _fastq("r2", r2m) + f">r3\n{r3}\n")
    return str(f), _oracle(R1, r2m, r3)


FILE_CASES = ["crlf_lowercase", "truncated_gzip", "garbage_between_fastq", "multimember_gzip",
              "fastq_cut_in_quality", "fastq_cut_before_plus", "leading_garbage", "no_marker",
              "mixed_fasta_fastq"]


@pytest.mark.parametrize("case", FILE_CASES)
def test_hostile_file_codes_both_readers(tmp_path, monkeypatch, case):
    """Each hostile file's codes through the port's native reader and its
    Python twin: equal to each other, to the JAX package's scan, and to
    what tests/test_edge_cases.py expects (a truncated gzip: a proper,
    nonempty prefix of its 50 reads' windows)."""
    path, want = _write_case(case, tmp_path)
    jax_codes = _jax_codes(path)
    if want is not None:
        np.testing.assert_array_equal(jax_codes, want)
    else:
        assert 0 < jax_codes.size < 50 * 70, "expected a proper prefix"
    for reader in ("native", "python"):
        np.testing.assert_array_equal(_port_codes(monkeypatch, path, reader), jax_codes,
                                      err_msg=reader)


def _detect_payload(targets: str, tmp_path, name: str) -> str:
    from strainer2_tpu_torch.pipeline import detect

    batch = tmp_path / f"{name}.txt"
    batch.write_text(f"SE\t{targets}\n")
    hits = str(tmp_path / f"{name}.gz")
    detect.run_detect("data/strainA.fna.gz", "expected/scrubbed_m05.txt", hits,
                      batch_list=str(batch), cfg=detect.DetectConfig(device="cpu"),
                      stdout=io.StringIO())
    with gzip.open(hits, "rt") as f:
        return f.read()


def _jax_detect_payload(targets: str, tmp_path, name: str) -> str:
    from strainer2_tpu.pipeline.detect import run_detect

    batch = tmp_path / f"jax_{name}.txt"
    batch.write_text(f"SE\t{targets}\n")
    hits = str(tmp_path / f"jax_{name}.gz")
    run_detect("data/strainA.fna.gz", "expected/scrubbed_m05.txt", hits,
               batch_list=str(batch), stdout=io.StringIO())
    with gzip.open(hits, "rt") as f:
        return f.read()


DETECT_TARGETS = {
    "empty": ("", 0, 0),
    "all_subk_reads": (">a\nACGT\n>b\nACGTACGT\n", 0, 0),
    # r1: 46 characters, 16 windows (IUPAC and lowercase); r2: 40 with N
    # flanks, 10 windows: the totals count windows whatever the letters
    "iupac": (">r1\nACGTRYSWKMBDHVacgtACGTACGTACGTACGTACGTACGTACGT\n"
              ">r2\nNNNNACGTACGTACGTACGTACGTACGTACGTACGTNNNN\n", 26, 2),
}


@pytest.mark.parametrize("case", list(DETECT_TARGETS))
def test_detect_hostile_targets(tmp_path, monkeypatch, case):
    """strain_detect on an empty target file, on reads all shorter than k
    and on reads with IUPAC letters: the four summary lines with the
    evaluated totals of tests/test_edge_cases.py, the same payload through
    the native packer and the Python one, and the JAX package's payload."""
    from strainer2_tpu_torch import native

    text, n_kmers, n_reads = DETECT_TARGETS[case]
    f = tmp_path / f"{case}.fasta"
    f.write_text(text)
    payload = _detect_payload(str(f), tmp_path, "native")
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        assert _detect_payload(str(f), tmp_path, "python") == payload
    lines = payload.splitlines()
    assert len(lines) >= 4
    assert lines[0].endswith(f"total_kmer_evaluated\t{n_kmers}")
    assert lines[1].endswith(f"total_reads_evaluated\t{n_reads}")
    if case == "empty":
        assert len(lines) == 4
    assert payload == _jax_detect_payload(str(f), tmp_path, case)


def _uninformative_reads(path, n: int = 40, length: int = 150) -> None:
    """A FASTA of n reads cut from the strain where none of the windows is
    a -a k-mer: each read hits, and none has an informative window."""
    from strainer2_tpu_torch.io.fastx import read_fastx
    from strainer2_tpu_torch.ops.packing_np import canonical_codes_np, encode_ascii_np

    genome = np.concatenate([encode_ascii_np(np.frombuffer(r.seq, dtype=np.uint8))
                             for r in read_fastx("data/strainA.fna.gz")])
    with open("expected/scrubbed_m05.txt", "rb") as f:
        kmers = [ln.strip() for ln in f if not ln.startswith(b"#")]
    informative = np.concatenate([canonical_codes_np(encode_ascii_np(np.frombuffer(m, np.uint8)),
                                                     K)[0] for m in kmers])
    codes, valid = canonical_codes_np(genome, K)
    bad = ~valid | np.isin(codes, informative)
    clean = np.flatnonzero(np.convolve(bad, np.ones(length - K + 1), "valid") == 0)
    starts = clean[:: max(1, clean.size // n)][:n]
    assert starts.size == n
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "w") as f:
        for i, s in enumerate(starts):
            f.write(f">u{i}\n{acgt[genome[s : s + length]].tobytes().decode()}\n")


# -B lines of the device-selection cases; "gate_with_zero_rows" runs with
# min_hits_for_informative_read 0 on reads that hit and carry no -a k-mer
SELECT_TARGETS = {
    "SE": "SE\tdata/target_SE.fastq\n",
    "PE": "PE\tdata/target_PE1.fasta.gz\tdata/target_PE2.fasta.gz\n",
    "PEI": "PEI\tdata/target_PEI.fasta\n",
    "gate_with_zero_rows": "SE\t{uninformative}\n",
}


@pytest.mark.parametrize("case", list(SELECT_TARGETS))
def test_detect_device_selection_equals_host_emission_and_jax(tmp_path, case):
    """strain_detect -B through the device route (K4 then K4e choose the
    rows; on the CPU their plain version), the mesh route (the host's
    _emit_sums: a rescan and a key search of every passing read) and the
    JAX package: the same hits file, byte for byte, in 8 x 1024 batches;
    every gated batch's rows come from the selection."""
    from strainer2_tpu.pipeline.detect import DetectConfig as JaxDetectConfig
    from strainer2_tpu.pipeline.detect import run_detect as jax_run_detect
    from strainer2_tpu_torch.pipeline import detect
    from strainer2_tpu_torch.utils import observability as obs

    uninformative = tmp_path / "uninformative.fasta"
    zero_rows = case == "gate_with_zero_rows"
    if zero_rows:
        _uninformative_reads(uninformative)
    batch = tmp_path / "targets.txt"
    batch.write_text(SELECT_TARGETS[case].format(uninformative=uninformative))
    min_i = 0 if zero_rows else 1

    def payload(name, run, cfg):
        hits = str(tmp_path / f"{name}.gz")
        run("data/strainA.fna.gz", "expected/scrubbed_m05.txt", hits, batch_list=str(batch),
            cfg=cfg, stdout=io.StringIO())
        with gzip.open(hits, "rb") as f:
            return f.read()

    obs.start_recording()
    device = payload("device", detect.run_detect,
                     detect.DetectConfig(device="cpu", min_hits_for_informative_read=min_i))
    _, counters = obs.stop_recording()
    host = payload("host", detect.run_detect,
                   detect.DetectConfig(device="cpu", min_hits_for_informative_read=min_i,
                                       mesh=(1, 1)))
    jax = payload("jax", jax_run_detect, JaxDetectConfig(min_hits_for_informative_read=min_i))
    assert device == host == jax
    assert counters["detect.select_batches"] == counters["detect.gate_passed"] > 0
    rows = [ln for ln in device.splitlines() if not ln.startswith(b"#")]
    assert counters.get("detect.rows", 0) == len(rows)
    if zero_rows:  # every read passes; no row is written
        assert counters["detect.reads_passing"] == 40 and not rows
    else:
        assert rows


def test_scrub_genome_with_subk_contig(tmp_path):
    """A sub-k contig in the genome is passed over (the reference
    segfaults on it): the index holds the other contig's k-mers, as the
    JAX package's does."""
    from strainer2_tpu.index.build import StrainIndex as JaxIndex
    from strainer2_tpu.pipeline.engine import KmerEngine
    from strainer2_tpu_torch.index.build import StrainIndex

    f = tmp_path / "g.fa"
    f.write_text(">c1\n" + "ACGTACGTAC" * 8 + "\n>tiny\nACGT\n")
    idx = StrainIndex.from_fasta(str(f), _engine(), ROWS, ROW_LEN)
    assert idx.num_kmers > 0
    np.testing.assert_array_equal(idx.codes, JaxIndex.from_fasta(str(f), KmerEngine(K)).codes)


def test_empty_panel_file_counts_nothing(tmp_path):
    import torch

    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.scrub_count import count_panel_file

    engine = _engine()
    index = StrainIndex.from_fasta("data/strainA.fna.gz", engine, ROWS, ROW_LEN)
    empty = tmp_path / "empty.fa"
    empty.write_text("")
    counts = torch.zeros(index.table.num_slots, dtype=torch.uint32)
    counts = count_panel_file(engine, index, counts, str(empty), ROWS, ROW_LEN)
    assert not counts.view(torch.int32).any()


SCRUB_UNREADABLE = {
    "genome": ("could not read file /nonexistent.fna.gz GEN_hash_sequences_set_count_vec()\n",
               None),
    "panel_list": ("could not read file /nonexistent_list.txt in GEN_all_kmer_counts()\n", None),
    "panel_entry_threads_1": ("could not read file /nonexistent_panel.fa.gz "
                              "in GEN_calculate_kmer_count()\n", "1"),
    "panel_entry_threads_4": ("could not read file /nonexistent_panel.fa.gz "
                              "in GEN_calculate_kmer_count()\n", "4"),
}


@pytest.mark.parametrize("case", list(SCRUB_UNREADABLE))
def test_scrub_unreadable_errors_match_reference(tmp_path, capsys, monkeypatch, case):
    """An unreadable -r, list or panel file exits 1 with the reference's
    exact stderr line (reference src/genome_compare.c:986,125,196); a
    panel list of two entries, so that 4 threads engage the pool."""
    from strainer2_tpu_torch.pipeline import scrub_count

    genome = str(tmp_path / "g.fa")
    with open(genome, "w") as f:
        f.write(">g\n" + "ACGT" * 50 + "\n")
    good_list = str(tmp_path / "good.txt")
    with open(good_list, "w") as f:
        f.write(genome + "\n")
    bad_list = str(tmp_path / "bad.txt")
    with open(bad_list, "w") as f:
        f.write("/nonexistent_panel.fa.gz\n" + genome + "\n")
    want, threads = SCRUB_UNREADABLE[case]
    args = {"genome": ("/nonexistent.fna.gz", good_list, good_list),
            "panel_list": (genome, "/nonexistent_list.txt", good_list)}.get(
                case, (genome, bad_list, good_list))
    if threads:
        monkeypatch.setenv("STRAINER2_COUNT_THREADS", threads)
    with pytest.raises(SystemExit) as e:
        scrub_count.run_scrub_count(*args, out=io.StringIO(),
                                    cfg=scrub_count.ScrubCountConfig(device="cpu"))
    assert e.value.code == 1
    assert capsys.readouterr().err.endswith(want)


COMPARE_UNREADABLE = {
    "query": ({"b_file": "/nonexistent_q.fa"},
              "could not read file /nonexistent_q.fa in GEN_calculate_coverage()\n"),
    "query_list": ({"b_list": "/nonexistent_list.txt"},
                   "could not read file /nonexistent_list.txt in GEN_all_coverage()\n"),
    "list_entry": ({"b_list": "LIST"},
                   "could not read file /nonexistent_q.fa in GEN_calculate_coverage()\n"),
}


@pytest.mark.parametrize("case", list(COMPARE_UNREADABLE))
def test_genome_compare_unreadable_errors_match_reference(tmp_path, capsys, case):
    """An unreadable query, list or list entry (the parallel scoring path)
    exits 1 with the reference's exact stderr line
    (src/genome_compare.c:289,251)."""
    from strainer2_tpu_torch.pipeline.compare import CompareConfig, run_genome_compare

    genome = str(tmp_path / "a.fa")
    with open(genome, "w") as f:
        f.write(">a\n" + "ACGTTGCA" * 40 + "\n")
    kwargs, want = COMPARE_UNREADABLE[case]
    if kwargs.get("b_list") == "LIST":
        blist = str(tmp_path / "qs.txt")
        with open(blist, "w") as f:
            f.write(genome + "\n/nonexistent_q.fa\n")
        kwargs = {"b_list": blist}
    with pytest.raises(SystemExit) as e:
        run_genome_compare(genome, cfg=CompareConfig(device="cpu", rows=ROWS, row_len=ROW_LEN),
                           out=io.StringIO(), **kwargs)
    assert e.value.code == 1
    assert capsys.readouterr().err.endswith(want)
