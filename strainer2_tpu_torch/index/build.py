"""Strain k-mer index, in the bucket or the cuckoo layout.

The state the JAX package's ``strainer2_tpu.index.build.StrainIndex``
carries, with the same meaning and the same npz file:

- ``codes``: distinct canonical k-mers (packed uint64) in first-encounter
  order, which the djb2 replay (index/refhash_order.py) turns into the
  reference's printed row order;
- ``genome_counts``: occurrences of each k-mer in the genome scan;
- ``table``: the membership table its layout names, built on first use:
  the bucket row table (index/bucket.py, the port's default) or the
  two-choice cuckoo table (index/cuckoo.py, what the JAX package builds
  on every backend but the TPU), with ``slot_of_key`` linking each code
  to its slot so slot-indexed device arrays gather back to key order.

An npz of either layout loads in either package; one with no ``layout``
entry is a cuckoo index, as the JAX package reads it.

The genome scan runs on the engine: the genome is packed into fixed
batches and every valid window's canonical code is extracted on the
device (kernel K1 on CUDA), then the codes come back in scan order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from strainer2_tpu_torch.constants import DEFAULT_K
from strainer2_tpu_torch.index.bucket import BucketTable, build_bucket_table
from strainer2_tpu_torch.index.cuckoo import CuckooTable, build_cuckoo
from strainer2_tpu_torch.io.batches import DEFAULT_ROW_LEN, DEFAULT_ROWS

__all__ = ["LAYOUTS", "StrainIndex", "check_layout", "scan_file_codes"]

LAYOUTS = ("bucket", "cuckoo")


def check_layout(layout: str) -> str:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown table layout {layout!r}: bucket or cuckoo")
    return layout


def scan_file_codes(path: str, engine, rows: int = DEFAULT_ROWS,
                    row_len: int = DEFAULT_ROW_LEN) -> np.ndarray:
    """All valid canonical codes of a FASTA/FASTQ file in genome-scan order,
    extracted by ``engine`` from packed batches (the k-1 halo between rows
    keeps every window exactly once and in order)."""
    from strainer2_tpu_torch.native import pack_file

    chunks = [engine.extract_codes(b.bases) for b in pack_file(path, engine.k, rows, row_len)]
    if not chunks:
        return np.empty(0, dtype=np.uint64)
    return np.concatenate(chunks)


@dataclass
class StrainIndex:
    k: int
    codes: np.ndarray  # (N,) uint64, first-encounter order
    genome_counts: np.ndarray  # (N,) uint32
    table_: BucketTable | CuckooTable | None = field(default=None, repr=False)
    layout_: str = "bucket"

    def __post_init__(self):
        check_layout(self.layout_)

    @property
    def layout(self) -> str:
        return self.table_.layout if self.table_ is not None else self.layout_

    @property
    def table(self) -> BucketTable | CuckooTable:
        if self.table_ is None:
            build = build_bucket_table if self.layout_ == "bucket" else build_cuckoo
            self.table_ = build(self.codes, self.k)
        return self.table_

    @classmethod
    def from_scan_codes(cls, scan_codes: np.ndarray, k: int = DEFAULT_K,
                        layout: str = "bucket") -> "StrainIndex":
        """Build from the full (with duplicates) genome-scan code stream."""
        if scan_codes.size == 0:
            raise ValueError("no valid k-mers found in genome")
        from strainer2_tpu_torch.native import unique_encounter_native

        native = unique_encounter_native(scan_codes)
        if native is not None:
            codes, genome_counts = native
        else:
            uniq, first_idx, counts = np.unique(
                scan_codes, return_index=True, return_counts=True
            )
            order = np.argsort(first_idx, kind="stable")
            codes = uniq[order]
            genome_counts = counts[order].astype(np.uint32)
        return cls(k=k, codes=codes, genome_counts=genome_counts, layout_=layout)

    @classmethod
    def from_unique_codes(cls, codes: np.ndarray, k: int = DEFAULT_K,
                          layout: str = "bucket") -> "StrainIndex":
        """Build from codes already known to be distinct (e.g. the union of
        several strains' key sets): skips the first-encounter unique pass."""
        codes = np.asarray(codes, dtype=np.uint64)
        if codes.size == 0:
            raise ValueError("no valid k-mers found in genome")
        return cls(k=k, codes=codes, genome_counts=np.ones(codes.shape[0], dtype=np.uint32),
                   layout_=layout)

    @classmethod
    def from_fasta(cls, path: str, engine, rows: int = DEFAULT_ROWS,
                   row_len: int = DEFAULT_ROW_LEN) -> "StrainIndex":
        """The index of a genome file, in the layout of ``engine``."""
        return cls.from_scan_codes(scan_file_codes(path, engine, rows, row_len), k=engine.k,
                                   layout=engine.layout)

    @property
    def num_kmers(self) -> int:
        return self.codes.shape[0]

    def slot_values(self, per_key: np.ndarray, fill=0) -> np.ndarray:
        """Scatter a per-key array into a (num_slots,) slot-indexed array."""
        out = np.full(self.table.num_slots, fill, dtype=np.asarray(per_key).dtype)
        out[self.table.slot_of_key] = per_key
        return out

    def key_values(self, per_slot: np.ndarray) -> np.ndarray:
        """Gather a slot-indexed (device result) array back to key order."""
        return np.asarray(per_slot)[self.table.slot_of_key]

    # ---- persistence: the npz of strainer2_tpu StrainIndex.save ----
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            k=self.k,
            codes=self.codes,
            genome_counts=self.genome_counts,
            table=self.table.table,
            slot_of_key=self.table.slot_of_key,
            h_bits=self.table.h_bits,
            salt=self.table.salt,
            layout=self.layout,
        )

    @classmethod
    def load(cls, path: str) -> "StrainIndex":
        z = np.load(path)
        layout = check_layout(str(z["layout"]) if "layout" in z else "cuckoo")
        table_cls = BucketTable if layout == "bucket" else CuckooTable
        table = table_cls(z["table"], z["slot_of_key"], int(z["h_bits"]), int(z["salt"]))
        return cls(k=int(z["k"]), codes=z["codes"], genome_counts=z["genome_counts"],
                   table_=table, layout_=layout)
