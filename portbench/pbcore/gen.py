"""The one generator of every cell's inputs, made from ``--seed``.

A configuration file (``portbench/configs/<name>.json``) fixes the
deployment: the strain genome or cohort, its informative sets and the
background panel.  A traffic mix (``portbench/traffic/<name>.json``) fixes
what each call scans: target samples, or the panel.  This module reads both
and writes FASTA.gz files (gzip level 1, compressed on threads) into a
directory; it keeps every base array in memory, so that the plain reference
(``reference.py``) works from the same inputs without reading the files.

Every array comes from its own stream, ``np.random.default_rng([seed, tag,
...])``: one seed gives the same files, and two seeds give files of the same
sizes.  Bases are codes 0-3 (A, C, G, T) and 4 for N.

Frozen copies of ``chip_smoke.py``'s ``write_fasta``, ``write_reads``,
``make_dataset`` and ``make_multi_dataset`` and of
``strainer2_tpu_torch/tools/bench_kernels.py``'s ``sample_reads`` and
``revcomp``, reworked to draw each file from a stream of its own and to
write gzip: the program may change, the yardstick may not.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
LINE = 80  # FASTA line width of genome files

# tags of the random streams
_STRAIN, _VARIANT, _INFORMATIVE, _PANEL_A, _PANEL_B, _TARGET, _WARM = range(1, 8)


def rng(seed: int, *tags: int) -> np.random.Generator:
    """The stream of one array: any whole seed (negative ones wrap)."""
    return np.random.default_rng([int(seed) % (1 << 64), *tags])


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of base codes along the last axis (N stays N)."""
    out = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
    return out[..., ::-1]


def canonical_codes(seq: np.ndarray, starts: np.ndarray, k: int) -> np.ndarray:
    """Canonical uint64 codes (max of the 2-bit forward and reverse
    complement codes) of the k-mers of ``seq`` at ``starts``."""
    win = seq[starts[:, None] + np.arange(k)].astype(np.uint64)
    weights = np.uint64(4) ** np.arange(k - 1, -1, -1, dtype=np.uint64)
    fwd = (win * weights).sum(axis=1, dtype=np.uint64)
    rc = ((np.uint64(3) - win)[:, ::-1] * weights).sum(axis=1, dtype=np.uint64)
    return np.maximum(fwd, rc)


def decode(codes: np.ndarray, k: int) -> np.ndarray:
    """(n, k) ASCII bytes of packed codes, first base in the high bits."""
    shifts = np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
    return ASCII[((codes[:, None] >> shifts) & np.uint64(3)).astype(np.intp)]


CHUNK = 16 << 20  # bytes a deflate chunk


def _deflate(data, last: bool) -> bytes:
    c = zlib.compressobj(1, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def gzip_bytes(data: bytes, pool: ThreadPoolExecutor | None = None) -> bytes:
    """One gzip member at level 1 with a fixed header (no name, mtime 0).
    Its deflate stream is made of 16 MiB chunks compressed apart (each but
    the last ends on a sync flush, as pigz makes them), on ``pool``."""
    view = memoryview(data)
    spans = [(lo, min(lo + CHUNK, len(data))) for lo in range(0, max(len(data), 1), CHUNK)]
    work = [(view[a:b], i == len(spans) - 1) for i, (a, b) in enumerate(spans)]
    parts = pool.map(lambda w: _deflate(*w), work) if pool else [_deflate(*w) for w in work]
    head = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03"
    tail = (zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little") + \
        (len(data) & 0xFFFFFFFF).to_bytes(4, "little")
    return head + b"".join(parts) + tail


def fasta_bytes(contigs: list[np.ndarray], prefix: str) -> bytes:
    parts = []
    for i, c in enumerate(contigs):
        n_lines = -(-c.size // LINE)
        body = np.full(n_lines * (LINE + 1), 10, dtype=np.uint8)
        text = np.full(n_lines * LINE, 10, dtype=np.uint8)
        text[: c.size] = ASCII[c]
        body.reshape(n_lines, LINE + 1)[:, :LINE] = text.reshape(n_lines, LINE)
        if c.size % LINE:  # the last line is short: drop its padding
            body = np.append(body[: (n_lines - 1) * (LINE + 1) + c.size % LINE], np.uint8(10))
        parts.append(f">{prefix}_{i}\n".encode() + body.tobytes())
    return b"".join(parts)


def reads_bytes(reads: np.ndarray) -> bytes:
    """(n, L) base codes -> FASTA records ``>r000000000``, one line each."""
    n, length = reads.shape
    rec = np.empty((n, 12 + length + 1), dtype=np.uint8)
    rec[:, 0:2] = np.frombuffer(b">r", np.uint8)
    ids = np.arange(n, dtype=np.int64)[:, None]
    rec[:, 2:11] = 48 + (ids // 10 ** np.arange(8, -1, -1)) % 10
    rec[:, 11] = 10
    rec[:, 12 : 12 + length] = ASCII[reads]
    rec[:, -1] = 10
    return rec.tobytes()


def add_n(r: np.random.Generator, reads: np.ndarray, rate: float) -> None:
    """Turn a seeded ``rate`` share of the bases into N, in place."""
    flat = reads.reshape(-1)
    flat[r.integers(0, flat.size, r.binomial(flat.size, rate))] = 4


@dataclass
class Strain:
    name: str
    path: str
    contigs: list
    informative_path: str
    informative: np.ndarray  # sorted distinct canonical codes


@dataclass
class Sample:
    kind: str  # "SE" or "PE"
    f1: str
    f2: str | None
    reads1: np.ndarray  # (n, L) base codes
    reads2: np.ndarray | None


@dataclass
class Panel:
    a_list: str
    b_list: str
    genomes: list  # [(path, contigs)]
    metagenomes: list  # [(path, reads)] distinct files
    b_entries: list  # indices into metagenomes, in -B list order


@dataclass
class Inputs:
    k: int
    strains: list = field(default_factory=list)
    samples: list = field(default_factory=list)
    batch_list: str | None = None
    panel: Panel | None = None
    warm_samples: list = field(default_factory=list)
    warm_batch_list: str | None = None
    warm_panel: Panel | None = None

    def target_windows(self) -> int:
        """Every window of every read of the samples: what a call scans."""
        return sum(_windows(s.reads1, self.k) + _windows(s.reads2, self.k) for s in self.samples)

    def panel_windows(self) -> int:
        """Every window of -A's contigs and of -B's entries."""
        p = self.panel
        a = sum(max(c.size - self.k + 1, 0) for _, contigs in p.genomes for c in contigs)
        b = sum(_windows(p.metagenomes[i][1], self.k) for i in p.b_entries)
        return a + b

    def distinct_panel_windows(self) -> int:
        p = self.panel
        a = sum(max(c.size - self.k + 1, 0) for _, contigs in p.genomes for c in contigs)
        return a + sum(_windows(reads, self.k) for _, reads in p.metagenomes)


def _windows(reads, k: int) -> int:
    if reads is None:
        return 0
    return reads.shape[0] * max(reads.shape[1] - k + 1, 0)


class _Writer:
    """Makes, compresses and writes files on thread pools (numpy and zlib
    drop the GIL for most of it): ``put`` queues a file, ``run`` a job that
    makes arrays."""

    def __init__(self, threads: int):
        self.pool = ThreadPoolExecutor(threads)
        self.chunks = ThreadPoolExecutor(threads)
        self.jobs = []

    def put(self, path: str, make) -> str:
        def job():
            data = gzip_bytes(make(), self.chunks)
            with open(path, "wb") as f:
                f.write(data)

        self.jobs.append(self.pool.submit(job))
        return path

    def run(self, fn):
        return self.pool.submit(fn)

    def close(self) -> None:
        try:
            for j in self.jobs:
                j.result()
        finally:
            self.pool.shutdown()
            self.chunks.shutdown()


def _split(genome: np.ndarray, n: int) -> list:
    return [np.ascontiguousarray(c) for c in np.array_split(genome, n)]


def sample_reads(r: np.random.Generator, sources: list, n: int, length: int, paired: bool,
                 insert: tuple[int, int], n_rate: float):
    """n reads (or pairs) of ``length``: for each (genome, share) of
    ``sources`` int(n * share) from that genome, on either strand; the rest
    random sequence.  A pair's mates are the two ends of a fragment of a
    seeded length in ``insert``, the second mate reverse-complemented."""
    reads1 = r.integers(0, 4, size=(n, length), dtype=np.uint8)
    reads2 = r.integers(0, 4, size=(n, length), dtype=np.uint8) if paired else None
    counts = [int(n * share) for _, share in sources]
    slots = r.permutation(n)[: sum(counts)]
    off = 0
    for (genome, _), m in zip(sources, counts):
        pos = slots[off : off + m]
        off += m
        if m == 0:
            continue
        frag = r.integers(insert[0], insert[1] + 1, size=m) if paired else np.full(m, length)
        starts = r.integers(0, genome.size - frag.max(), size=m)
        flip = r.random(m) < 0.5
        head = genome[starts[:, None] + np.arange(length)]
        if not paired:
            head[flip] = revcomp(head[flip])
            reads1[pos] = head
            continue
        tail = genome[(starts + frag - length)[:, None] + np.arange(length)]
        rtail = revcomp(tail)
        reads1[pos] = np.where(flip[:, None], rtail, head)
        reads2[pos] = np.where(flip[:, None], head, rtail)
    add_n(r, reads1, n_rate)
    if paired:
        add_n(r, reads2, n_rate)
    return reads1, reads2


def window_codes(contig: np.ndarray, k: int) -> np.ndarray:
    """Canonical uint64 codes of every window of an N-free contig, rolled
    one base at a time (no (n, k) matrix, for genome-sized contigs)."""
    n = contig.size - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    x = contig.astype(np.uint64)
    fwd = np.zeros(n, dtype=np.uint64)
    rc = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        xj = x[j : j + n]
        fwd = fwd * np.uint64(4) + xj
        rc += (np.uint64(3) - xj) << np.uint64(2 * j)
    return np.maximum(fwd, rc)


def _scrubbed(r: np.random.Generator, kmers: list, s: int, n_keep: int) -> np.ndarray:
    """Strain ``s``'s informative set after the -C scrub: ``n_keep`` of its
    k-mers drawn from those in no other strain's genome (kmer_scrub_filter
    deletes every k-mer with a drug count, then keeps min_fraction of all
    k-mers; it aborts where fewer than twice that are left)."""
    own = kmers[s]
    shared = np.zeros(own.size, dtype=bool)
    for o, other in enumerate(kmers):
        if o != s and other.size:
            at = np.searchsorted(other, own).clip(max=other.size - 1)
            shared |= other[at] == own
    left = own[~shared]
    if left.size < 2 * n_keep:
        raise ValueError(f"strain {s}: {left.size} k-mers in no other strain, fewer than "
                         f"twice the {n_keep} to keep")
    return np.sort(r.choice(left, n_keep, replace=False))


def _strains(cfg: dict, seed: int, d: str, w: _Writer) -> list:
    """The configuration's strains: ``strains`` variants of one seeded
    genome, each base changed at ``snp_rate``, each with a seeded
    ``informative_fraction`` of its k-mers informative; in a cohort (more
    than one strain) scrubbed as -C scrubs them."""
    k = cfg["k"]
    base = rng(seed, _STRAIN).integers(0, 4, size=cfg["strain_bp"], dtype=np.uint8)
    genomes = []
    for s in range(cfg["strains"]):
        g = base
        if cfg["snp_rate"] > 0:
            r = rng(seed, _VARIANT, s)
            g = base.copy()
            hit = r.integers(0, g.size, r.binomial(g.size, cfg["snp_rate"]))
            g[hit] = (g[hit] + r.integers(1, 4, hit.size, dtype=np.uint8)) % 4
        genomes.append(_split(g, cfg["strain_contigs"]))
    kmers = None
    if len(genomes) > 1:
        kmers = [np.unique(np.concatenate([window_codes(c, k) for c in contigs]))
                 for contigs in genomes]
    out = []
    for s, contigs in enumerate(genomes):
        name = f"strain_{s:02d}"
        r = rng(seed, _INFORMATIVE, s)
        codes = []
        for c in contigs:
            n = c.size - k + 1
            starts = np.unique(r.integers(0, n, r.binomial(n, cfg["informative_fraction"])))
            codes.append(canonical_codes(c, starts, k))
        informative = np.unique(np.concatenate(codes))
        if kmers is not None:
            informative = _scrubbed(r, kmers, s, informative.size)
        inf_path = os.path.join(d, f"{name}.informative.txt")
        with open(inf_path, "wb") as f:
            f.write(f"#seeded {cfg['informative_fraction']} sample of {name}'s k-mers\n"
                    f"#post scrub kmers {informative.size}\n".encode())
            rows = np.empty((informative.size, k + 1), dtype=np.uint8)
            rows[:, :k] = decode(informative, k)
            rows[:, k] = 10
            f.write(rows.tobytes())
        path = w.put(os.path.join(d, f"{name}.fna.gz"),
                     lambda contigs=contigs, name=name: fasta_bytes(contigs, name))
        out.append(Strain(name, path, contigs, inf_path, informative))
    return out


def _panel(cfg: dict, seed: int, d: str, w: _Writer, base: np.ndarray, sizes: dict,
           tag: str) -> Panel:
    """-A genomes sharing a share of their blocks with ``base``, and -B
    metagenomes of reads with a share from ``base``."""
    genomes = []
    block = cfg["panel_block_bp"]
    for g in range(sizes["genomes"]):
        r = rng(seed, _PANEL_A, g, sizes["tag"])
        bp = sizes["genome_bp"]
        seq = r.integers(0, 4, size=bp, dtype=np.uint8)
        n_blocks = bp // block
        for b in r.choice(n_blocks, size=int(n_blocks * cfg["panel_shared_fraction"]),
                          replace=False):
            src = int(r.integers(0, base.size - block))
            seq[b * block : (b + 1) * block] = base[src : src + block]
        path = w.put(os.path.join(d, f"{tag}genome{g}.fna.gz"),
                     lambda seq=seq, g=g: fasta_bytes([seq], f"genome{g}"))
        genomes.append((path, [seq]))
    metas = []
    for m in range(sizes["metagenomes"]):
        r = rng(seed, _PANEL_B, m, sizes["tag"])
        reads, _ = sample_reads(r, [(base, cfg["metagenome_strain_fraction"])], sizes["reads"],
                                cfg["read_len"], False, (0, 0), cfg["n_rate"])
        path = w.put(os.path.join(d, f"{tag}meta{m}.fasta.gz"),
                     lambda reads=reads: reads_bytes(reads))
        metas.append((path, reads))
    entries = [i % len(metas) for i in range(sizes["entries"])]
    a_list = os.path.join(d, f"{tag}genomes.txt")
    b_list = os.path.join(d, f"{tag}metagenomes.txt")
    with open(a_list, "w") as f:
        f.write("".join(p + "\n" for p, _ in genomes))
    with open(b_list, "w") as f:
        f.write("".join(metas[i][0] + "\n" for i in entries))
    return Panel(a_list, b_list, genomes, metas, entries)


def _samples(cfg: dict, mix: dict, specs: list, seed: int, d: str, w: _Writer,
             strains: list, tag: int, prefix: str) -> tuple[list, str]:
    genomes = [np.concatenate(s.contigs) for s in strains]

    def make(j, spec):
        r = rng(seed, tag, j)
        present = spec.get("present_strains", len(strains))
        chosen = np.sort(r.permutation(len(strains))[:present])
        share = spec["strain_fraction"] / present
        paired = spec["type"] == "PE"
        return sample_reads(r, [(genomes[s], share) for s in chosen],
                            spec["pairs"] if paired else spec["reads"], cfg["read_len"], paired,
                            tuple(mix.get("insert", (300, 500))), mix["n_rate"])

    made = [w.run(lambda j=j, spec=spec: make(j, spec)) for j, spec in enumerate(specs)]
    out = []
    for j, spec in enumerate(specs):
        reads1, reads2 = made[j].result()
        paired = spec["type"] == "PE"
        stem = os.path.join(d, f"{prefix}{j}")
        if paired:
            f1 = w.put(f"{stem}_1.fasta.gz", lambda x=reads1: reads_bytes(x))
            f2 = w.put(f"{stem}_2.fasta.gz", lambda x=reads2: reads_bytes(x))
        else:
            f1, f2 = w.put(f"{stem}.fasta.gz", lambda x=reads1: reads_bytes(x)), None
        out.append(Sample(spec["type"], f1, f2, reads1, reads2))
    batch_list = os.path.join(d, f"{prefix}batch.txt")
    with open(batch_list, "w") as f:
        for s in out:
            f.write(f"PE\t{s.f1}\t{s.f2}\n" if s.kind == "PE" else f"SE\t{s.f1}\n")
    return out, batch_list


def make_inputs(cfg: dict, mix: dict, seed: int, d: str, threads: int = 8) -> Inputs:
    """Write the inputs of (configuration, mix) into ``d`` and return them.

    The mix's ``samples`` are the target samples of one call; ``panel``
    true makes the configuration's -A and -B panel.  ``warm_samples`` and
    ``warm_panel`` are the small inputs of the warm-up call, which runs the
    cell's shapes once before the window."""
    w = _Writer(threads)
    try:
        inp = Inputs(k=cfg["k"])
        inp.strains = _strains(cfg, seed, d, w)
        if mix.get("samples"):
            inp.samples, inp.batch_list = _samples(cfg, mix, mix["samples"], seed, d, w,
                                                   inp.strains, _TARGET, "target")
            inp.warm_samples, inp.warm_batch_list = _samples(
                cfg, mix, mix["warm_samples"], seed, d, w, inp.strains, _WARM, "warm")
        if mix.get("panel"):
            base = np.concatenate(inp.strains[0].contigs)
            inp.panel = _panel(cfg, seed, d, w, base, {
                "genomes": cfg["panel_genomes"], "genome_bp": cfg["panel_genome_bp"],
                "metagenomes": cfg["distinct_metagenomes"], "reads": cfg["metagenome_reads"],
                "entries": cfg["metagenome_entries"], "tag": 0}, "")
            wp = mix["warm_panel"]
            inp.warm_panel = _panel(cfg, seed, d, w, base, {
                "genomes": 1, "genome_bp": wp["genome_bp"], "metagenomes": 1,
                "reads": wp["reads"], "entries": 1, "tag": 1}, "warm_")
    finally:
        w.close()
    return inp
