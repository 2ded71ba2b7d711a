"""The plain reference: what each call has to produce, worked out again.

Plain PyTorch (and NumPy for the row order), written from the stages'
documented semantics, not from the program: it imports nothing of
``strainer2_tpu_torch`` or of the JAX package.  It takes the base arrays
that ``gen.py`` wrote into the input files and gives

- detection (``strain_detect`` / ``detect-multi``): each strain's hits
  payload, every row and summary line of each sample, in order.  A read (an
  SE sample) or a pair (PE) passes for a strain where its windows hit the
  strain's k-mers at least once and its informative k-mers at least once;
  a passing read's row is one per window that is a valid informative
  k-mer, ``<f1>\\t<t1>\\t<i1>\\t<t2>\\t<i2>\\t<canonical k-mer>``, mate 1's
  windows first (reference src/strain_detect.c:403-406, 554-636);
- panel counting (``kmer_scrub_count``): the table of the strain's
  distinct canonical k-mers with their genome, -A and -B counts, in the
  reference's printed row order: djb2 of the k-mer string into an open
  hash of 8,000,000 slots with linear probing, doubled (old slots in
  order) once the keys before an insert reach half of it (reference
  src/BIO_hash.c:14-22, 39-61, 111-139, 208-216; src/kmer_scrub_count.c:
  134-156).

A window is valid where its k bases are all A, C, G or T; its code is the
larger of the 2-bit forward and reverse-complement codes.

``fingerprinted=True`` is the control: the same, with k-mer membership
decided by a 32-bit fingerprint of the code in place of the whole code.
That breaks the exactness the configurations state, the step a faster
table might take.
"""

from __future__ import annotations

from array import array
from dataclasses import dataclass

import numpy as np
import torch

from pbcore.gen import decode

HASH_CAPACITY = 8_000_000  # the reference's initial hash size (src/genome_compare.h:20)
BLOCK = 1 << 16  # reads a block


@dataclass
class Stats:
    """What a call reads and finds, for the byte counts."""
    bases: int = 0
    reads: int = 0
    valid: int = 0  # valid windows
    hits: int = 0  # valid windows whose k-mer is a strain's

    def add(self, o: "Stats") -> None:
        self.bases += o.bases
        self.reads += o.reads
        self.valid += o.valid
        self.hits += o.hits


def fingerprint(codes: torch.Tensor) -> torch.Tensor:
    return (codes ^ (codes >> 32)) & 0xFFFFFFFF


def window_codes(seqs: torch.Tensor, k: int):
    """Canonical codes (int64) and validity of every window of the rows of
    ``seqs`` ((n, L) base codes, 4 for N)."""
    b = seqs.to(torch.int64)
    x = b & 3
    n, length = b.shape
    w = length - k + 1
    fwd = torch.zeros((n, w), dtype=torch.int64, device=b.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        xj = x[:, j : j + w]
        fwd.mul_(4).add_(xj)
        rc.add_((3 - xj) * (4**j))
    bad = torch.zeros((n, length + 1), dtype=torch.int32, device=b.device)
    bad[:, 1:] = torch.cumsum((b > 3).to(torch.int32), dim=1)
    valid = (bad[:, k:] - bad[:, :w]) == 0
    return torch.maximum(fwd, rc), valid


def contig_codes(contigs: list, k: int, device) -> torch.Tensor:
    """Codes of every valid window of the contigs, in scan order."""
    out = []
    for c in contigs:
        codes, valid = window_codes(torch.from_numpy(c).to(device)[None, :], k)
        out.append(codes[valid])
    return torch.cat(out)


class KeySet:
    """Sorted distinct keys; ``find`` gives each query's key index or -1."""

    def __init__(self, keys: torch.Tensor, fingerprinted: bool):
        self.keys = keys  # sorted, distinct
        self.fingerprinted = fingerprinted
        if fingerprinted:
            fp = fingerprint(keys)
            self.fp, order = torch.sort(fp, stable=True)
            self.fp_key = order  # the first key of each fingerprint wins a tie

    def find(self, q: torch.Tensor) -> torch.Tensor:
        table = self.fp if self.fingerprinted else self.keys
        if self.fingerprinted:
            q = fingerprint(q)
        if table.numel() == 0:
            return torch.full_like(q, -1)
        pos = torch.searchsorted(table, q).clamp_(max=table.numel() - 1)
        found = table[pos] == q
        if self.fingerprinted:
            pos = self.fp_key[pos]
        return torch.where(found, pos, torch.full_like(pos, -1))


# ---- detection ---------------------------------------------------------------

class Cohort:
    """S strains over the union of their k-mers: per union key, whether it
    is a k-mer (``present``) and an informative k-mer of each strain."""

    def __init__(self, strains: list, k: int, device, fingerprinted: bool = False):
        sets = [torch.unique(contig_codes(s.contigs, k, device)) for s in strains]
        self.n_kmers = [int(x.numel()) for x in sets]
        union = torch.unique(torch.cat(sets))
        self.keys = KeySet(union, fingerprinted)
        n = len(strains)
        self.present = torch.zeros((union.numel(), n), dtype=torch.bool, device=device)
        self.informative = torch.zeros_like(self.present)
        self.n_informative = []
        for s, (x, st) in enumerate(zip(sets, strains)):
            self.present[torch.searchsorted(union, x), s] = True
            inf = torch.from_numpy(st.informative.astype(np.int64)).to(device)
            at = torch.searchsorted(union, inf).clamp_(max=union.numel() - 1)
            ok = (union[at] == inf) & self.present[at, s]
            # an informative k-mer that is not the strain's would be
            # reported and skipped by the stage; the generator makes none
            if not bool(ok.all()):
                raise ValueError(f"strain {s}: informative k-mers outside its genome")
            self.informative[at, s] = True
            self.n_informative.append(int(inf.numel()))

    def sums(self, seqs: torch.Tensor, k: int):
        """Per read and strain (total, informative) hits, and the codes,
        the per-window informative bits and the stats of a block."""
        codes, valid = window_codes(seqs, k)
        idx = self.keys.find(codes)
        hit = valid & (idx >= 0)
        at = idx.clamp(min=0)
        pm = self.present[at] & hit[..., None]
        im = self.informative[at] & hit[..., None]
        st = Stats(bases=seqs.numel(), reads=seqs.shape[0], valid=int(valid.sum()),
                   hits=int(pm.any(-1).sum()))
        return pm.sum(1), im.sum(1), codes, im, st


_POW10 = np.array([10**i for i in range(1, 20)], dtype=np.uint64)


def _digits(v: np.ndarray):
    """Right-aligned ASCII digits of unsigned ints and the mask of the
    digits that are printed."""
    v = v.astype(np.uint64)
    n_dig = np.searchsorted(_POW10, v, side="right") + 1
    width = int(n_dig.max(initial=1))
    mat = np.empty((v.size, width), dtype=np.uint8)
    x = v.copy()
    for j in range(width - 1, -1, -1):
        mat[:, j] = 48 + (x % np.uint64(10)).astype(np.uint8)
        x //= np.uint64(10)
    return mat, np.arange(width)[None, :] >= (width - n_dig)[:, None]


def format_rows(parts: list) -> bytes:
    """Rows made of columns, in order: a bytes constant, an (n,) unsigned
    int array printed in decimal, or an (n, m) uint8 array of ASCII."""
    n = next(p.shape[0] for p in parts if isinstance(p, np.ndarray))
    mats, masks = [], []
    for p in parts:
        if isinstance(p, bytes):
            mats.append(np.broadcast_to(np.frombuffer(p, np.uint8), (n, len(p))))
            masks.append(np.ones((n, len(p)), dtype=bool))
        elif p.ndim == 1:
            m, mask = _digits(p)
            mats.append(m)
            masks.append(mask)
        else:
            mats.append(p)
            masks.append(np.ones(p.shape, dtype=bool))
    return np.concatenate(mats, axis=1)[np.concatenate(masks, axis=1)].tobytes()


def detect_expected(strains: list, samples: list, k: int, device,
                    fingerprinted: bool = False):
    """Each strain's payload (the decompressed bytes of its hits file) for
    one call over ``samples``, and the call's Stats."""
    cohort = Cohort(strains, k, device, fingerprinted)
    n_strains = len(strains)
    payload = [[] for _ in range(n_strains)]
    stats = Stats()
    for smp in samples:
        paired = smp.kind == "PE"
        f1 = smp.f1.encode()
        n = smp.reads1.shape[0]
        for lo in range(0, n, BLOCK):
            mates = [smp.reads1[lo : lo + BLOCK]] + ([smp.reads2[lo : lo + BLOCK]] if paired else [])
            got = []
            for m in mates:
                t, i, codes, im, st = cohort.sums(torch.from_numpy(m).to(device), k)
                got.append((t, i, codes, im))
                stats.add(st)
            t1, i1, c, im = got[0]
            if paired:
                t2, i2 = got[1][0], got[1][1]
                c = torch.cat([c, got[1][2]], dim=1)
                im = torch.cat([im, got[1][3]], dim=1)
            else:
                t2, i2 = torch.zeros_like(t1), torch.zeros_like(i1)
            passing = ((t1 + t2) >= 1) & ((i1 + i2) >= 1)
            for s in range(n_strains):
                r, w = torch.nonzero(im[:, :, s] & passing[:, s : s + 1], as_tuple=True)
                if r.numel() == 0:
                    continue
                cols = [x[r, s].cpu().numpy() for x in (t1, i1, t2, i2)]
                kmers = decode(c[r, w].cpu().numpy().astype(np.uint64), k)
                payload[s].append(format_rows([f1 + b"\t", cols[0], b"\t", cols[1], b"\t",
                                               cols[2], b"\t", cols[3], b"\t", kmers, b"\n"]))
        w_read = max(smp.reads1.shape[1] - k + 1, 0)
        evaluated = n * w_read * (2 if paired else 1)
        for s in range(n_strains):
            payload[s].append(
                b"#%s\ttotal_kmer_evaluated\t%d\n#%s\ttotal_reads_evaluated\t%d\n"
                b"#%s\ttotal_genome_kmers\t%d\n#%s\ttotal_genome_informative_kmers\t%d\n"
                % (f1, evaluated, f1, n if w_read else 0, f1, cohort.n_kmers[s], f1,
                   cohort.n_informative[s]))
    return [b"".join(p) for p in payload], stats


# ---- panel counting ----------------------------------------------------------

def djb2(codes: torch.Tensor, k: int) -> torch.Tensor:
    """djb2 of each code's ACGT string, mod 2**32 (src/BIO_hash.c:208-216)."""
    text = torch.tensor([65, 67, 71, 84], dtype=torch.int64, device=codes.device)
    h = torch.full_like(codes, 5381)
    for j in range(k):
        h = (h * 33 + text[(codes >> (2 * (k - 1 - j))) & 3]) & 0xFFFFFFFF
    return h


def printed_order(hashes: np.ndarray, capacity: int = HASH_CAPACITY) -> np.ndarray:
    """Slot order of keys inserted in index order into the reference's
    open hash: ``hashes[i] % capacity`` and linear probing; after an insert
    that found at least capacity/2 keys already in, the capacity doubles
    and the keys move over in old slot order."""
    hs = hashes.tolist()
    m = capacity
    table = array("q", [-1]) * m
    for i, hv in enumerate(hs):
        s = hv % m
        while table[s] != -1:
            s += 1
            if s == m:
                s = 0
        table[s] = i
        if i >= m // 2:
            m2 = m * 2
            t2 = array("q", [-1]) * m2
            for key in table:
                if key != -1:
                    s = hs[key] % m2
                    while t2[s] != -1:
                        s += 1
                        if s == m2:
                            s = 0
                    t2[s] = key
            table, m = t2, m2
    out = np.frombuffer(table, dtype=np.int64)
    return out[out >= 0].copy()


def count_expected(strain, panel, k: int, device, fingerprinted: bool = False,
                   capacity: int = HASH_CAPACITY):
    """The count table (bytes) of one call over ``panel``, and its Stats."""
    codes = contig_codes(strain.contigs, k, device)
    keys, inverse, genome_counts = torch.unique(codes, return_inverse=True, return_counts=True)
    first = torch.full((keys.numel(),), codes.numel(), dtype=torch.int64, device=device)
    first.scatter_reduce_(0, inverse, torch.arange(codes.numel(), device=device), "amin")
    encounter = torch.argsort(first)  # key indices in first-encounter order
    ks = KeySet(keys, fingerprinted)
    stats = Stats()

    def count(seqs: torch.Tensor, times: int) -> torch.Tensor:
        c, valid = window_codes(seqs, k)
        idx = ks.find(c[valid])
        hit = idx[idx >= 0]
        stats.add(Stats(bases=seqs.numel() * times, reads=0, valid=int(valid.sum()) * times,
                        hits=hit.numel() * times))
        return torch.bincount(hit, minlength=keys.numel()) * times

    pan = torch.zeros(keys.numel(), dtype=torch.int64, device=device)
    for _, contigs in panel.genomes:
        for c in contigs:
            pan += count(torch.from_numpy(c).to(device)[None, :], 1)
    meta = torch.zeros_like(pan)
    times = np.bincount(panel.b_entries, minlength=len(panel.metagenomes))
    for m, (_, reads) in enumerate(panel.metagenomes):
        if times[m]:
            for lo in range(0, reads.shape[0], BLOCK):
                meta += count(torch.from_numpy(reads[lo : lo + BLOCK]).to(device), int(times[m]))
    enc = encounter.cpu().numpy()
    order = enc[printed_order(djb2(keys[encounter], k).cpu().numpy(), capacity)]
    cols = [x.cpu().numpy()[order] for x in (genome_counts, pan, meta)]
    kmers = decode(keys.cpu().numpy().astype(np.uint64)[order], k)
    body = []
    for lo in range(0, order.size, 1 << 20):
        sl = slice(lo, lo + (1 << 20))
        body.append(format_rows([kmers[sl], b"\t", cols[0][sl], b"\t", cols[1][sl], b"\t",
                                 cols[2][sl], b"\n"]))
    head = b"#kmer\treference_count\tpangenome_count\tmetagenome_count\tdrug_count\n"
    return head + b"".join(body), stats
