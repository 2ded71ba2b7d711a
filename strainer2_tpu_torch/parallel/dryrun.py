"""The port's twins of ``__graft_entry__.py``'s entry points: the one-device
forward step and the multi-device dry run over every (data, index)
factorization of a mesh.

    python -m strainer2_tpu_torch.parallel.dryrun [--devices cuda:0] [-n 4]

``entry`` gives the forward step the JAX ``entry()`` gives (canonical
windows, bucket probe, +1 into the count buffer: K3 on a card, its plain
version on the CPU) with its example arguments.  ``dryrun_multichip`` runs
the sharded programs of parallel/sharding.py at every factorization of
n devices into (data, index), index a power of two, in both layouts, for
3, 20 and 100 strains and through the scrub facade's row-padding path, and
asserts each equal to the one-device engine on the mesh's first device,
as the JAX ``dryrun_multichip`` does.  ``devices`` is make_mesh's: None or
a bare ``cuda`` needs n cards; ``cuda:0`` or ``cpu`` lays every shard on
that one device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

K = 31


def entry(device="cuda"):
    """(fn, example_args): fn(counts, rows, bases) adds one into counts at
    the slot of every valid window of ``bases`` whose key ``rows`` holds
    (K3, ``ops.lookup.count_step``) and returns counts."""
    from strainer2_tpu_torch.index.bucket import build_bucket_table
    from strainer2_tpu_torch.ops.lookup import count_step
    from strainer2_tpu_torch.pipeline.engine import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    codes = np.unique(rng.integers(0, 1 << 62, size=100_000, dtype=np.uint64))
    t = build_bucket_table(codes, K)
    h_bits, salt = t.h_bits, t.salt

    def forward(counts, rows, bases):
        return count_step(counts, rows, bases, h_bits, salt, K)

    bases = rng.integers(0, 5, size=(64, 2048), dtype=np.uint8)
    example_args = (
        torch.zeros(t.num_slots, dtype=torch.uint32, device=dev),
        torch.from_numpy(t.table).to(dev),
        torch.from_numpy(bases).to(dev),
    )
    return forward, example_args


def _strain_words(rng, n_keys: int, n_strains: int) -> list[np.ndarray]:
    """Per-key meta words of n_strains synthetic strains: bit 2 s of word
    s // 16 present (60%), bit 2 s + 1 informative (half of those)."""
    words = []
    for j in range(-(-n_strains // 16)):
        w = np.zeros(n_keys, dtype=np.uint32)
        for s in range(16 * j, min(16 * (j + 1), n_strains)):
            present = rng.random(n_keys) < 0.6
            informative = present & (rng.random(n_keys) < 0.5)
            w |= present.astype(np.uint32) << np.uint32(2 * (s - 16 * j))
            w |= informative.astype(np.uint32) << np.uint32(2 * (s - 16 * j) + 1)
        words.append(w)
    return words


def _tile_rows(arr: np.ndarray, n_data: int) -> np.ndarray:
    """A one-device batch replicated across the data axis (row-major)."""
    return np.asarray(arr) if n_data == 1 else np.tile(np.asarray(arr), (n_data, 1))


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Every (data, index) factorization of n_devices, index a power of
    two: sharded counting and classification in both layouts, multi-strain
    classification at 3, 20 (two meta words) and 100 strains (seven, on
    144-lane rows), and the ShardedPanelEngine facade with an odd row count,
    each asserted equal to the one-device engine.  Returns the mesh shapes
    run and the multi-strain widths checked at each."""
    from strainer2_tpu_torch.index.bucket import build_bucket_table
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.io.batches import max_reads_capacity, pack_stream
    from strainer2_tpu_torch.ops.packing_np import canonical_codes_np
    from strainer2_tpu_torch.parallel.sharding import ShardedKmerEngine, ShardedPanelEngine, make_mesh
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    rows_base, row_len = 8, 256
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, size=4096, dtype=np.uint8)
    scan, valid = canonical_codes_np(genome, K)
    index = StrainIndex.from_scan_codes(scan[valid], k=K, layout="cuckoo")
    t = index.table
    tb = build_bucket_table(index.codes, K)
    max_reads = max_reads_capacity(K, rows_base, row_len)
    reads = []
    for _ in range(6 * max(n_devices, 4)):
        ln = int(rng.integers(40, 120))
        start = int(rng.integers(0, genome.size - ln))
        reads.append(genome[start : start + ln])
    batches = list(pack_stream(reads, K, rows=rows_base, row_len=row_len, with_read_ids=True))
    n_windows = rows_base * (row_len - K + 1)

    def bounds(b):
        out = np.full(max_reads + 1, n_windows, dtype=np.int32)
        out[: b.n_reads] = b.window_starts
        return out

    shapes = []
    n_index = 1
    while n_index <= n_devices:
        if n_devices % n_index == 0:
            shapes.append((n_devices // n_index, n_index))
        n_index *= 2
    ref_dev = make_mesh(*shapes[0], devices=devices).device(0, 0)

    # ---- one-device references on the mesh's first device ----
    eng_c = TorchKmerEngine(K, max_reads, device=ref_dev, layout="cuckoo")
    eng_b = TorchKmerEngine(K, max_reads, device=ref_dev, layout="bucket")
    kinds = np.full(index.num_kmers, 2, np.uint32)  # all informative
    meta_c = index.slot_values(kinds)
    meta_b = np.zeros(tb.num_slots, np.uint32)
    meta_b[tb.slot_of_key] = kinds
    rows_meta = tb.with_meta(meta_b)
    table_c = eng_c.table_for(index)
    meta_c_dev = eng_c.to_device(meta_c)
    counts_ref = eng_c.init_counts(index)
    tot_ref = []
    for b in batches:
        counts_ref = eng_c.count_batch(counts_ref, table_c, t.h_bits, t.salt, b.bases)
        tot, inf = eng_c.classify_batch(table_c, t.h_bits, t.salt, b.bases, bounds(b),
                                        meta=meta_c_dev)
        tot_ref.append((tot.cpu().numpy(), inf.cpu().numpy()))
    key_counts_ref = index.key_values(eng_c.finalize_counts(counts_ref))
    assert int(key_counts_ref.sum()) > 0, "dry run produced no k-mer hits"

    multi = {}  # strains -> (table, rows, one-device (tot, inf) a batch)
    for n_strains in (3, 20, 100):
        n_words = -(-n_strains // 16)
        tbs = tb if n_words <= 2 else build_bucket_table(index.codes, K, row_width=32 + 16 * n_words)
        slot_words = []
        for w in _strain_words(rng, index.num_kmers, n_strains):
            sw = np.zeros(tbs.num_slots, np.uint32)
            sw[tbs.slot_of_key] = w
            slot_words.append(sw)
        rows = tbs.with_meta_words(slot_words)
        rows_dev = eng_b.to_device(rows)
        ref = [tuple(x.cpu().numpy() for x in eng_b.classify_multi_batch(
            rows_dev, tbs.h_bits, tbs.salt, b.bases, bounds(b), n_strains)) for b in batches]
        assert sum(int(r[0][:, -1].sum()) for r in ref) > 0, f"no hits of strain {n_strains - 1}"
        multi[n_strains] = (tbs, rows, ref)

    checked = {}
    for n_data, n_index in shapes:
        mesh = make_mesh(n_data, n_index, devices=devices)
        # cuckoo layout: count + classify over rows replicated n_data times
        sh_c = ShardedKmerEngine(K, mesh, t.h_bits, t.salt, t.num_slots, layout="cuckoo")
        tab = sh_c.put_table(t.table, meta_c)
        counts = sh_c.init_counts()
        for b in batches:
            counts = sh_c.count_batch(counts, tab, _tile_rows(b.bases, n_data))
        got = index.key_values(sh_c.merge_counts(counts))
        assert (got == key_counts_ref * n_data).all(), f"cuckoo counts at {n_data}x{n_index}"
        for b, (tot1, inf1) in zip(batches, tot_ref):
            tot_s, inf_s = sh_c.classify_batch(tab, _tile_rows(b.bases, n_data), bounds(b))
            # the data shards past the first see windows past every read
            assert (tot_s[0] == tot1).all() and (inf_s[0] == inf1).all()
            assert not tot_s[1:].any() and not inf_s[1:].any()
        del tab
        # bucket layout: count + classify + multi-strain classify
        widths = []
        if tb.table.shape[0] % n_index == 0:
            sh_b = ShardedKmerEngine(K, mesh, tb.h_bits, tb.salt, tb.num_slots, layout="bucket")
            rows_sh = sh_b.put_table(rows_meta)
            counts_b = sh_b.init_counts()
            for b in batches:
                counts_b = sh_b.count_batch(counts_b, rows_sh, _tile_rows(b.bases, n_data))
            got_b = sh_b.merge_counts(counts_b)[tb.slot_of_key]
            assert (got_b == key_counts_ref * n_data).all(), f"bucket counts at {n_data}x{n_index}"
            del rows_sh
            for n_strains, (tbs, rows, ref) in multi.items():
                if tbs.table.shape[0] % n_index:
                    continue  # a toy table narrower than the index axis
                sh_m = ShardedKmerEngine(K, mesh, tbs.h_bits, tbs.salt, tbs.num_slots,
                                         layout="bucket")
                rows_m = sh_m.put_table(rows)
                for b, (mt1, mi1) in zip(batches, ref):
                    mt, mi = sh_m.classify_multi_batch(rows_m, _tile_rows(b.bases, n_data),
                                                       bounds(b), n_strains)
                    assert (mt[0] == mt1).all() and (mi[0] == mi1).all(), \
                        f"{n_strains} strains at {n_data}x{n_index}"
                    assert not mt[1:].any() and not mi[1:].any()
                widths.append(n_strains)
        # the scrub facade, its pad-to-the-data-axis path on an odd row count
        panel = ShardedPanelEngine(index, n_data, n_index, devices=devices)
        pcounts = panel.init_counts(index)
        part = rows_base - 1 if n_data > 1 else rows_base
        one = eng_c.init_counts(index)
        for b in batches:
            pcounts = panel.count_batch(pcounts, panel.table_for(index), t.h_bits, t.salt,
                                        b.bases[:part])
            one = eng_c.count_batch(one, table_c, t.h_bits, t.salt, b.bases[:part])
        merged = index.key_values(panel.finalize_counts(pcounts))
        assert (merged == index.key_values(eng_c.finalize_counts(one))).all()
        assert int(merged.sum()) > 0
        checked[f"{n_data}x{n_index}"] = widths
    return {"shapes": checked}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-n", "--n-devices", type=int, default=None,
                    help="mesh size (default: the visible cards, or 8 with --devices cpu)")
    ap.add_argument("--devices", default="cuda",
                    help="make_mesh's devices: cuda (every visible card), cuda:N or cpu (one device "
                         "holds every shard)")
    args = ap.parse_args(argv)
    n = args.n_devices
    if n is None:
        n = torch.cuda.device_count() if args.devices == "cuda" else 8
    fn, example = entry(args.devices if args.devices != "cuda" else "cuda:0")
    out = fn(*example)
    print(f"entry ok: {tuple(out.shape)} {int(out.view(torch.int32).sum())}", flush=True)
    print(f"dryrun_multichip({n}) ok: {dryrun_multichip(n, args.devices)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
