"""Device mesh of the port: data-parallel reads x index-parallel table, in
one process.

The torch twin of ``strainer2_tpu.parallel.sharding`` (``--mesh DxI``).  A
``Mesh`` is a (data, index) grid of torch devices driven by one process:

- **index axis**: the membership table is split into I contiguous shards,
  whole buckets (bucket layout) or slots (cuckoo layout) each with their
  fingerprints and classes; shard i sits on every device of column i, one
  copy a device (``P("index", None)`` / ``P("index")`` in JAX).  It is how
  a table that outgrows one card spreads over the cards of a host.
- **data axis**: a batch's rows, padded to a multiple of D with base 4,
  split into D contiguous blocks; row block d runs on the devices of row d.

Every shard-local program is a hand-written kernel with the shard's window
([lo, lo + n) of the buckets or slots): counting (K3s) adds into the
device's private (slots / I,) count shard with no collective, and the
counts merge once a run (``merge_counts``, uint32 that wraps, as JAX's
``jnp.sum(dtype=uint32)``).  Classification (K4s, K6s) probes each shard,
then the psum over the index axis is one reduce kernel (R) on the data
shard's first device, (d, 0), which reads each shard's buffer where it lies
there: (d, 0)'s own, and the others' after a copy to (d, 0) (none where
they share its device); K4's sums launch or K7 then runs unchanged on the
data shard's read boundaries clipped to its window range, and the per-read
partials come back to the host as (n_data, ...) arrays summed over axis 0,
as in JAX.
Each launch runs on its shard's device, so the cards work concurrently.

A key lives in one slot of one shard, so the results equal one device's
(tests/test_torch_sharding.py holds them to JAX's ShardedKmerEngine).  The
one corner: a cuckoo key held in both of its slots, which neither package's
builder makes (both place each unique code once).  Within a shard the
window probe takes s1's slot, as JAX's ``_local_lookup`` does; across two
shards the counts land in both slots (as in JAX), and classification ORs
the shards' informative bits where JAX compares the sum of their classes
with 2.

Device resolution (``make_mesh``): a bare ``cuda`` is the visible cards
``cuda:0..n-1`` and needs D x I == n (JAX's rule); one explicit device
(``cpu``, ``cuda:N``) holds every shard, the stand-in for XLA's virtual
host devices that splits an index for real on one card or the CPU; a list
of D x I devices is taken as given, shard (d, i) on the (d * I + i)-th.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from strainer2_tpu_torch.index.build import check_layout
from strainer2_tpu_torch.ops.lookup import (
    classify_sums,
    cuckoo_fingerprints,
    shard_classify_masks,
    shard_count_step,
    shard_cuckoo_classify_masks,
    shard_cuckoo_count_step,
    shard_reduce,
)
from strainer2_tpu_torch.ops.segsum import (
    boundary_strain_sums,
    shard_multi_hit_words,
    words_for_strains,
)

__all__ = ["Mesh", "make_mesh", "shard_table", "TableShard", "ShardedKmerEngine",
           "ShardedPanelEngine", "pad_rows"]

KEYS_PER_BUCKET = 16


class Mesh:
    """A (data, index) grid of torch devices; ``shape`` as JAX's Mesh names
    its axes."""

    def __init__(self, grid: list[list[torch.device]]):
        self.grid = grid
        self.shape = {"data": len(grid), "index": len(grid[0])}

    def device(self, d: int, i: int) -> torch.device:
        return self.grid[d][i]

    @property
    def devices(self) -> list[torch.device]:
        """Every device of the grid, row-major (shard (d, i) at d * I + i)."""
        return [dev for row in self.grid for dev in row]


def _cuda_required(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {what!r} requested but torch.cuda.is_available() is false "
            "(pass --device cpu to run the plain torch path on the CPU)"
        )


def make_mesh(data: int, index: int = 1, devices=None) -> Mesh:
    """A (data, index) mesh over ``devices``: None or a bare ``cuda`` is the
    visible cards (data * index must equal their number, the JAX
    ``make_mesh`` rule, strainer2_tpu/parallel/sharding.py:45-50); one
    explicit device (``cpu`` or ``cuda:N``) holds every shard; a list of
    data * index devices is taken as given."""
    if data < 1 or index < 1:
        raise ValueError(f"mesh {data}x{index}: both axes need at least one device")
    if devices is None:
        devices = "cuda"
    if isinstance(devices, (str, torch.device)):
        dev = torch.device(devices)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {devices!r}: use cuda or cpu")
        if dev.type == "cuda":
            _cuda_required(str(devices))
        if dev.type == "cuda" and dev.index is None:
            flat = [torch.device("cuda", j) for j in range(torch.cuda.device_count())]
        else:
            if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
                raise ValueError(f"device {dev} is not one of the "
                                 f"{torch.cuda.device_count()} visible cards")
            flat = [dev] * (data * index)
    else:
        flat = [torch.device(x) for x in devices]
    if data * index != len(flat):
        raise ValueError(f"mesh {data}x{index} != {len(flat)} devices")
    return Mesh([[flat[d * index + i] for i in range(index)] for d in range(data)])


@dataclass
class TableShard:
    """Index shard of a table: its first bucket (bucket layout) or slot
    (cuckoo layout), its rows or slots, their slot-indexed classes (cuckoo
    classification) and, on a device, a cuckoo shard's slot fingerprints;
    None where there are none."""

    lo: int
    table: object
    meta: object = None
    fp: object = None


def shard_table(table, layout: str, n_index: int, meta=None) -> list[TableShard]:
    """A JAX-layout table split along the index axis: the bucket rows (with
    meta, or the wide union rows: any 32 + 16 j lanes) in whole buckets, or
    the cuckoo (2H, 2) slots with their slot-indexed ``meta`` array in
    slots.  The shards are views of ``table`` (numpy or torch).  Raises
    the JAX ValueError where the slots do not divide evenly
    (strainer2_tpu/parallel/sharding.py:99-100)."""
    per_row = KEYS_PER_BUCKET if check_layout(layout) == "bucket" else 1
    num_slots = table.shape[0] * per_row
    if num_slots % n_index:
        raise ValueError("num_slots must divide evenly across the index axis")
    if table.shape[0] % n_index:
        raise ValueError(f"{table.shape[0]} buckets do not split into {n_index} shards of whole "
                         "buckets")
    n = table.shape[0] // n_index
    return [TableShard(i * n, table[i * n : (i + 1) * n],
                       None if meta is None else meta[i * n : (i + 1) * n])
            for i in range(n_index)]


def pad_rows(arr: np.ndarray, n_data: int, fill) -> np.ndarray:
    """``arr`` with rows of ``fill`` appended to a multiple of n_data (base
    4 for bases, -1 for read ids: strainer2_tpu/pipeline/detect.py:1022-1036)."""
    pad = (-arr.shape[0]) % n_data
    if not pad:
        return arr
    return np.concatenate([arr, np.full((pad, arr.shape[1]), fill, dtype=arr.dtype)])


def _tensor(x, dev: torch.device) -> torch.Tensor:
    """``x`` (numpy or torch) contiguous on ``dev``; uint32 crosses as its
    int32 view (CUDA torch copies few uint32 ops)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if t.dtype == torch.uint32:
        return t.contiguous().view(torch.int32).to(dev).view(torch.uint32)
    return t.contiguous().to(dev)


class ShardedTable:
    """A table on a mesh: shard i on every device of index column i, one
    copy a device (``shards[i][device]``: a TableShard of tensors, with the
    slot fingerprints of a cuckoo shard as ``fp``)."""

    def __init__(self, mesh: Mesh, layout: str, shards: list[TableShard]):
        self.layout = layout
        self.shards: list[dict] = []
        for i, sh in enumerate(shards):
            on = {}
            for d in range(mesh.shape["data"]):
                dev = mesh.device(d, i)
                if dev in on:
                    continue
                t = _tensor(sh.table, dev)
                on[dev] = TableShard(sh.lo, t, None if sh.meta is None else _tensor(sh.meta, dev),
                                     cuckoo_fingerprints(t) if layout == "cuckoo" else None)
            self.shards.append(on)

    def at(self, mesh: Mesh, d: int, i: int) -> TableShard:
        return self.shards[i][mesh.device(d, i)]


class ShardedKmerEngine:
    """Sharded twins of the engine's counting and classification programs
    (JAX ShardedKmerEngine, strainer2_tpu/parallel/sharding.py:81).

    counts: per (d, i) a private (num_slots / I,) uint32 tensor on device
    (d, i); ``merge_counts`` sums them over the data axis on the host.
    Batches reach the engine with rows a multiple of the data axis
    (``pad_rows``)."""

    def __init__(self, k: int, mesh: Mesh, h_bits: int, salt: int, num_slots: int,
                 layout: str = "cuckoo"):
        self.k = k
        self.mesh = mesh
        self.h_bits = h_bits
        self.salt = salt
        self.num_slots = num_slots
        self.layout = check_layout(layout)
        self.n_data = mesh.shape["data"]
        self.n_index = mesh.shape["index"]
        if num_slots % self.n_index:
            raise ValueError("num_slots must divide evenly across the index axis")
        self.shard_rows = num_slots // self.n_index
        if layout == "bucket" and self.shard_rows % KEYS_PER_BUCKET:
            raise ValueError(f"{num_slots // KEYS_PER_BUCKET} buckets do not split into "
                             f"{self.n_index} shards of whole buckets")

    # ---- device state ----
    def put_table(self, table, meta=None) -> ShardedTable:
        """``table`` (the JAX layout, numpy or torch) and, for cuckoo
        classification, its slot-indexed classes on the mesh."""
        n_rows = self.num_slots // (KEYS_PER_BUCKET if self.layout == "bucket" else 1)
        if table.shape[0] != n_rows:
            raise ValueError(f"a table of {table.shape[0]} rows for {self.num_slots} slots")
        return ShardedTable(self.mesh, self.layout,
                            shard_table(table, self.layout, self.n_index, meta))

    def init_counts(self) -> list[list[torch.Tensor]]:
        return [[torch.zeros(self.shard_rows, dtype=torch.uint32, device=self.mesh.device(d, i))
                 for i in range(self.n_index)] for d in range(self.n_data)]

    def counts_from_numpy(self, counts_np: np.ndarray) -> list[list[torch.Tensor]]:
        """Merged counts (num_slots,) back on the mesh: data row 0 holds them,
        the other rows zeros (JAX ShardedPanelEngine.counts_from_numpy)."""
        counts = self.init_counts()
        c = np.asarray(counts_np, dtype=np.uint32)
        for i in range(self.n_index):
            counts[0][i] = _tensor(c[i * self.shard_rows : (i + 1) * self.shard_rows].copy(),
                                   self.mesh.device(0, i))
        return counts

    def merge_counts(self, counts) -> np.ndarray:
        """Collapse the data axis: (num_slots,) uint32, bit-identical to one
        device's counts (the adds wrap in uint32, as on the device)."""
        cols = []
        for i in range(self.n_index):
            col = np.zeros(self.shard_rows, dtype=np.uint32)
            for d in range(self.n_data):
                col += counts[d][i].cpu().numpy()
            cols.append(col)
        return np.concatenate(cols)

    def _data_blocks(self, bases) -> tuple[list[dict], tuple[int, int]]:
        """Row block d of ``bases`` on every device of mesh row d, and a
        block's (rows, length)."""
        bases = np.asarray(bases)
        if bases.shape[0] % self.n_data:
            raise ValueError(f"{bases.shape[0]} rows do not split over {self.n_data} data "
                             "shards: pad them (pad_rows)")
        per = bases.shape[0] // self.n_data
        out = []
        for d in range(self.n_data):
            block = torch.from_numpy(np.ascontiguousarray(bases[d * per : (d + 1) * per]))
            out.append({dev: block.to(dev) for dev in dict.fromkeys(self.mesh.grid[d])})
        return out, (per, bases.shape[1])

    def _clipped(self, boundaries: np.ndarray, d: int, n_local: int) -> torch.Tensor:
        """Data shard d's read boundaries, clip(b - d * n_local, 0, n_local)
        (sharding.py:297-300, :333-340), on its first device."""
        b = np.clip(np.asarray(boundaries, dtype=np.int64) - d * n_local, 0, n_local)
        return torch.from_numpy(b.astype(np.int32)).to(self.mesh.device(d, 0))

    def _reduced(self, parts: list, d: int, masks: bool):
        """The psum over the index axis of the I shards' outputs (K4s's
        (masks, counts), or K6s's words): R on (d, 0) reads part 0 where it
        lies and the others copied there (no copy where they share its
        device); the one shard's own output where I is 1."""
        if len(parts) == 1:
            return parts[0]
        dev0 = self.mesh.device(d, 0)
        return shard_reduce([(p[0] if masks else p).reshape(-1).view(torch.int32).to(dev0)
                             .view(torch.uint32) for p in parts], masks=masks)

    # ---- programs ----
    def count_batch(self, counts, table: ShardedTable, bases):
        """K3s on every (d, i): counts[d][i] += 1 at the local slot of each
        valid window of row block d whose key shard i holds, in place."""
        blocks, _ = self._data_blocks(bases)
        for d in range(self.n_data):
            for i in range(self.n_index):
                sh = table.at(self.mesh, d, i)
                dev = self.mesh.device(d, i)
                if self.layout == "bucket":
                    shard_count_step(counts[d][i], sh.table, sh.lo, blocks[d][dev], self.h_bits,
                                     self.salt, self.k)
                else:
                    shard_cuckoo_count_step(counts[d][i], sh.table, sh.lo, blocks[d][dev],
                                            self.h_bits, self.salt, self.k, fp=sh.fp)
        return counts

    def classify_batch(self, table: ShardedTable, bases, boundaries):
        """Per-data-shard (total, informative) partials, two (n_data,
        max_reads) int32 arrays; sum over axis 0 for the per-read counts.
        ``boundaries``: (max_reads + 1,) flat window starts of the batch's
        reads (both layouts: the JAX cuckoo program takes read ids, whose
        per-read sums are the same)."""
        blocks, shape = self._data_blocks(bases)
        n_local = shape[0] * (shape[1] - self.k + 1)
        outs = []
        for d in range(self.n_data):
            b = self._clipped(boundaries, d, n_local)
            parts = []
            for i in range(self.n_index):
                sh = table.at(self.mesh, d, i)
                x = blocks[d][self.mesh.device(d, i)]
                if self.layout == "bucket":
                    parts.append(shard_classify_masks(sh.table, sh.lo, x, self.h_bits, self.salt,
                                                      self.k))
                else:
                    parts.append(shard_cuckoo_classify_masks(sh.table, sh.meta, sh.lo, x,
                                                             self.h_bits, self.salt, self.k,
                                                             fp=sh.fp))
            outs.append(classify_sums(*self._reduced(parts, d, masks=True), shape, self.k, b))
        tot = np.stack([t.cpu().numpy() for t, _ in outs])
        inf = np.stack([f.cpu().numpy() for _, f in outs])
        return tot, inf

    def classify_multi_batch(self, table: ShardedTable, bases, boundaries, n_strains: int,
                             with_words: bool = False):
        """Multi-strain classification, bucket layout only (JAX
        sharding.py:370-397): per-data-shard (n_data, max_reads, n_strains)
        int32 partials of per-read total and informative hits.  With
        ``with_words``, also each data shard's reduced K6 words, (Q / D,
        ceil(S / 16)) uint32 on its first device, in data-shard order."""
        if self.layout != "bucket":
            raise ValueError("classify_multi_batch requires the bucket layout")
        n_words = words_for_strains(n_strains)
        blocks, shape = self._data_blocks(bases)
        n_local = shape[0] * (shape[1] - self.k + 1)
        outs, words = [], []
        for d in range(self.n_data):
            b = self._clipped(boundaries, d, n_local)
            parts = []
            for i in range(self.n_index):
                sh = table.at(self.mesh, d, i)
                parts.append(shard_multi_hit_words(sh.table, sh.lo, blocks[d][self.mesh.device(d, i)],
                                                   self.h_bits, self.salt, self.k, n_words))
            w = self._reduced(parts, d, masks=False).reshape(n_local, n_words)
            outs.append(boundary_strain_sums(w, b, n_strains))
            words.append(w)
        tot = np.stack([t.cpu().numpy() for t, _ in outs])
        inf = np.stack([f.cpu().numpy() for _, f in outs])
        return (tot, inf, words) if with_words else (tot, inf)


class ShardedPanelEngine:
    """The engine facade of the scrub stage over a (data, index) mesh (JAX
    ShardedPanelEngine, strainer2_tpu/parallel/sharding.py:400): the scrub
    loop runs unchanged, bit-identical to one device (integer count merge)."""

    def __init__(self, index, n_data: int, n_index: int, devices=None):
        self.k = index.k
        self.layout = index.layout
        self.mesh = make_mesh(n_data, n_index, devices=devices)
        t = index.table
        self._engine = ShardedKmerEngine(index.k, self.mesh, t.h_bits, t.salt, t.num_slots,
                                         layout=index.layout)
        self._table = self._engine.put_table(t.table)
        self.n_data = n_data

    def table_for(self, index):
        return self._table

    def init_counts(self, index):
        return self._engine.init_counts()

    def counts_from_numpy(self, index, counts_np):
        return self._engine.counts_from_numpy(counts_np)

    def finalize_counts(self, counts) -> np.ndarray:
        return self._engine.merge_counts(counts)

    def count_batch(self, counts, table, h_bits, salt, bases):
        # pad rows to a multiple of the data axis (sharding.py:452-460)
        return self._engine.count_batch(counts, table, pad_rows(np.asarray(bases), self.n_data, 4))
