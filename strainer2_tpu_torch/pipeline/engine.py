"""Device engine of the single-strain path: the torch twin of KmerEngine.

One ``TorchKmerEngine`` = one k, one table layout and one batch geometry
on one explicit device.  It keeps the part of
``strainer2_tpu.pipeline.engine.KmerEngine``'s contract that the ported
stages use, in either layout:

- ``extract_codes``: canonical codes of a packed buffer (kernel K1);
- ``table_for`` / ``init_counts`` / ``counts_from_numpy`` /
  ``finalize_counts``: the device state's life cycle;
- ``count_batch`` (K3) and ``count_batch_with_valid`` (K3 with its valid
  count, strain-track: a tally from ``init_valid_tally``, read once by
  ``valid_total``); ``classify_batch`` (K4);
- ``hit_accumulate`` (K8) and ``hit_stats`` (K9): genome_compare's
  containment tallies, reduced on the device;
- ``classify_multi_batch``: the multi-strain classify, K6
  (``hit_words_batch``) then K7 (``strain_sums``), bucket layout only, as
  the JAX multi-strain detector forces it.

``layout`` is "bucket" (the default: one 64-byte row a probe, the
detection class in the row) or "cuckoo" (two 8-byte slots a probe, the
class in a separate slot-indexed array; the cuckoo_ kernels).  The JAX
package picks cuckoo on every backend but the TPU
(``strainer2_tpu.pipeline.engine.default_layout``), from v5e and CPU
measurements; on the H100 the port keeps bucket as its default on both
devices, so that a run reads the same table it always did, until the
bucket-vs-cuckoo cell of a port benchmark decides (PERF.md §6 has the
first kernel times of both).  An index of either layout from either
package runs on an engine of its layout.

On a CUDA device every step runs a hand-written kernel; on the CPU the
same calls run the kernels' plain torch versions.  A CUDA device that is
not there is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from strainer2_tpu_torch.index.build import check_layout
from strainer2_tpu_torch.ops.lookup import (
    classify_step,
    count_step,
    count_valid_step,
    cuckoo_classify_step,
    cuckoo_count_step,
    cuckoo_count_valid_step,
    cuckoo_hit_accumulate,
    cuckoo_hit_stats,
    hit_accumulate,
    hit_stats,
    n_tiles,
    valid_tally_total,
)
from strainer2_tpu_torch.ops.packing import canonical_windows
from strainer2_tpu_torch.ops.packing_np import merge_code64_np
from strainer2_tpu_torch.ops.segsum import boundary_strain_sums, multi_hit_words, words_for_strains

__all__ = ["TorchKmerEngine", "resolve_device"]


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is false "
            "(pass --device cpu to run the plain torch path on the CPU)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev


# count, count with its valid tally, hit accumulate, hit stats of a layout
_STEPS = {
    "bucket": (count_step, count_valid_step, hit_accumulate, hit_stats),
    "cuckoo": (cuckoo_count_step, cuckoo_count_valid_step, cuckoo_hit_accumulate,
               cuckoo_hit_stats),
}


def index_layout(index) -> str:
    """The layout of an index of either package (or a view with a table):
    a table that names none is a cuckoo table, as the JAX package reads it."""
    return getattr(index.table, "layout", "cuckoo")


class TorchKmerEngine:
    def __init__(self, k: int, max_reads: int | None = None, device="cuda",
                 layout: str = "bucket"):
        self.k = k
        self.max_reads = max_reads
        self.device = resolve_device(device)
        self.layout = check_layout(layout)
        self._count, self._count_valid, self._hit_accum, self._hit_stats = _STEPS[layout]
        self._tables: dict[int, tuple[object, torch.Tensor]] = {}

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ---- index construction path ----
    def extract_codes(self, bases: np.ndarray) -> np.ndarray:
        """All valid canonical codes of a packed (rows, L) buffer, in scan
        order, as uint64."""
        hi, lo, valid = canonical_windows(self.to_device(bases), self.k)
        mask = valid.reshape(-1)
        # masked through int32 views: CUDA torch indexes no uint32 tensors
        hi = hi.view(torch.int32).reshape(-1)[mask].cpu().numpy().view(np.uint32)
        lo = lo.view(torch.int32).reshape(-1)[mask].cpu().numpy().view(np.uint32)
        return merge_code64_np(hi, lo, self.k)

    # ---- device state life cycle ----
    def table_for(self, index) -> torch.Tensor:
        """The index's table on the device (uploaded once): the bucket rows,
        or the (2H, 2) uint32 cuckoo slots.  Takes this package's
        StrainIndex or the JAX package's, of the engine's layout."""
        if index_layout(index) != self.layout:
            raise ValueError(f"a {index_layout(index)} index on a {self.layout} engine")
        key = id(index)
        hit = self._tables.get(key)
        if hit is None or hit[0] is not index:
            hit = (index, self.to_device(index.table.table))
            self._tables[key] = hit
        return hit[1]

    def init_counts(self, index) -> torch.Tensor:
        return torch.zeros(index.table.num_slots, dtype=torch.uint32, device=self.device)

    def counts_from_numpy(self, index, counts_np: np.ndarray) -> torch.Tensor:
        # a copy: on the CPU, to_device would alias the caller's array, and
        # the count step updates the buffer in place
        return self.to_device(np.array(counts_np, dtype=np.uint32))

    def finalize_counts(self, counts: torch.Tensor) -> np.ndarray:
        return counts.cpu().numpy()

    # ---- panel counting (kmer_scrub_count hot loop) ----
    def count_batch(self, counts, table, h_bits: int, salt: int, bases) -> torch.Tensor:
        """counts[slot] += 1 per valid hit window of ``bases``, in place."""
        return self._count(counts, table, self.to_device(bases), h_bits, salt, self.k)

    def init_valid_tally(self, rows: int, row_len: int) -> torch.Tensor:
        """A zeroed int64 valid-window tally for a stream of batches of at
        most (rows, row_len): a slot a 256-window tile."""
        return torch.zeros(max(1, n_tiles(rows, row_len, self.k)), dtype=torch.int64,
                           device=self.device)

    def count_batch_with_valid(self, counts, tally, table, h_bits: int, salt: int, bases):
        """count_batch, and this batch's valid windows added into ``tally``
        on the device, in place; no per-batch reduction or readback."""
        return self._count_valid(counts, tally, table, self.to_device(bases), h_bits, salt,
                                 self.k)

    def valid_total(self, tally) -> int:
        """The valid windows of every batch counted into ``tally``: one
        reduction and one readback a stream."""
        return int(valid_tally_total(tally))

    # ---- containment scoring (genome_compare) ----
    def init_accumulator(self) -> torch.Tensor:
        """The (hits, valid windows) int64 accumulator of ``hit_accumulate``."""
        return torch.zeros(2, dtype=torch.int64, device=self.device)

    def hit_accumulate(self, acc, table, h_bits: int, salt: int, bases) -> torch.Tensor:
        """acc (2,) int64 (hits, evaluated) += this batch's tallies, in place
        on the device: the fullmap path reads it back once a file."""
        return self._hit_accum(acc, table, self.to_device(bases), h_bits, salt, self.k)

    def hit_stats(self, table, h_bits: int, salt: int, bases, remaining: int) -> torch.Tensor:
        """Rapid-mode batch stats reduced on the device: int32 (4,) of
        (batch hits, batch evaluated, hits at the crossing, crossing
        position), the position being the flat index of the batch's
        ``remaining``-th valid window (-1 if the batch ends first) and the
        hits the inclusive prefix there: the reference's stop-and-test
        point (reference src/genome_compare.c:327-340)."""
        return self._hit_stats(table, self.to_device(bases), remaining, h_bits, salt, self.k)

    # ---- detection: per-read hit aggregation ----
    def classify_batch(self, table, h_bits: int, salt: int, bases, boundaries, meta=None):
        """Per-read (total_hits, informative_hits), int32 (max_reads,) on the
        device; entries past the batch's reads are zero.

        table: bucket rows with the k-mer class in meta lane block 32:48, or
        the cuckoo slots, whose class is ``meta``, a (2H,) uint32 device
        array (the bucket layout takes none).
        boundaries: (max_reads + 1,) int32 first flat window index of each
        read, padded with the batch's window count."""
        bases, boundaries = self.to_device(bases), self.to_device(boundaries)
        if self.layout == "bucket":
            return classify_step(table, bases, boundaries, h_bits, salt, self.k)
        if meta is None:
            raise ValueError("the cuckoo layout classifies with a slot-indexed meta array")
        return cuckoo_classify_step(table, meta, bases, boundaries, h_bits, salt, self.k)

    def classify_multi_batch(self, rows, h_bits: int, salt: int, bases, boundaries,
                             n_strains: int):
        """Per-read, per-strain (total, informative) hits, each an int32
        (max_reads, n_strains) matrix on the device; the torch twin of
        ``multi_detect._classify_multi`` (K6 then K7).

        rows: the union table, strain s's two bits in meta word s // 16.
        boundaries: as in ``classify_batch``."""
        words = self.hit_words_batch(rows, h_bits, salt, bases, n_strains)
        return self.strain_sums(words, boundaries, n_strains)

    def hit_words_batch(self, rows, h_bits: int, salt: int, bases, n_strains: int):
        """K6: every window's meta words, (Q, ceil(S/16)) uint32 on the
        device, 0 on a miss or an invalid window."""
        if self.layout != "bucket":
            raise ValueError("multi-strain classification runs on bucket rows only: "
                             "use a bucket engine, as the JAX multi-strain detector does")
        return multi_hit_words(
            rows, self.to_device(bases), h_bits, salt, self.k, words_for_strains(n_strains)
        )

    def strain_sums(self, words, boundaries, n_strains: int):
        """K7: per-read, per-strain (total, informative) of K6's words."""
        return boundary_strain_sums(words, self.to_device(boundaries), n_strains)
