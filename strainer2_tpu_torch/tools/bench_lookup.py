"""A/B of the membership lookups on one device: the ring of bulk async
key_hi copies (K5) against K2 and the plain torch lookup, and the cuckoo
layout's two-probe lookup (K10) on a table of the same keys.

    python -m strainer2_tpu_torch.tools.bench_lookup [--kmers 6700000] [--queries 262144] \\
        [--variants plain,k2,ring8x4,ring8x8,ring16x4,ring16x8,k10] [--row-width 64] \\
        [--device cuda]

The torch twin of tools/bench_pallas_lookup.py.  A table of --kmers random
k-mers (seed 11) with a seeded meta word per slot, and SLICES slices of
--queries lookups each, half of them present.  ``ringWxD`` is K5 with w=W
rows a group and up to D groups in flight a ring; its ``chunk`` (queries
per block) is 2 W D, so that a 262,144-query step gives the card thousands
of blocks.

Every bucket variant is checked exactly (found, slot, meta) against K2 and
the plain version on every slice.  ``k10`` looks the same queries up in the
cuckoo table of the same keys (index/cuckoo.py), through its slot
fingerprints (a byte a slot: 16 MiB for 6.7 M keys, 64 MiB for the 19.5 M
of a 32-strain union, more than the 50 MB L2): its (found, slot) must
equal the plain cuckoo lookup's, and its found set and the key at each
found slot K2's.  Timing follows the original's chain method:
N_SHORT and N_LONG lookup steps over the rotated slices, each chain timed
with CUDA events (host clock on the CPU, where every variant is the plain
version), the marginal per-step time reported as M lookups/s, and the
chains' checksums (sum of found meta, or of found slots for k10, + found
count, mod 2**32) checked for linearity.  Exit status 1 when a variant disagrees or a checksum is not
linear.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

K = 31
SLICES = 4
N_SHORT, N_LONG = 4, 36
_MASK32 = 0xFFFFFFFF

__all__ = ["bench", "main"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kmers", type=int, default=6_700_000)
    ap.add_argument("--queries", type=int, default=262_144, help="lookups per chain step")
    ap.add_argument("--variants", default="plain,k2,ring8x4,ring8x8,ring16x4,ring16x8,k10")
    ap.add_argument("--row-width", type=int, default=64, choices=(64, 128, 288),
                    help="bucket row lanes: 64 (the detection row), 128, 288 (256 strains)")
    ap.add_argument("--device", default="cuda")
    return ap


def _as_i64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & _MASK32
    return t.to(torch.int64)


def _max_abs_err(a, b) -> int:
    return max(int((_as_i64(x) - _as_i64(y)).abs().max()) if x.numel() else 0
               for x, y in zip(a, b))


def _checksum(found: torch.Tensor, meta: torch.Tensor) -> int:
    m = _as_i64(meta)
    return int((torch.where(found, m, 0).sum() + found.sum()).item()) & _MASK32


def _variant(name: str, rows, h_bits: int, salt: int):
    """The lookup of a bucket variant; k10's is made in ``bench``."""
    from strainer2_tpu_torch.ops import lookup as L

    if name == "plain":
        return lambda qh, ql: L.bucket_lookup_plain(rows, h_bits, salt, qh, ql)
    if name == "k2":
        return lambda qh, ql: L.bucket_lookup(rows, h_bits, salt, qh, ql)
    if name.startswith("ring"):
        w, d = (int(x) for x in name[len("ring"):].split("x"))
        return lambda qh, ql: L.bucket_lookup_ring(rows, h_bits, salt, qh, ql, w=w, d=d,
                                                   chunk=2 * w * d)
    raise ValueError(f"unknown variant {name!r}: plain, k2, ringWxD or k10")


def bench(argv: list[str] | None = None, out=None) -> dict:
    """Run the A/B; returns {variant: {"ms", "mlookups_s", "err_k2",
    "err_plain", "sums", "linear"}} plus "ok" and "device"."""
    from strainer2_tpu_torch.index.bucket import build_bucket_table
    from strainer2_tpu_torch.index.cuckoo import build_cuckoo
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.ops.packing_np import split_code64_np
    from strainer2_tpu_torch.pipeline.engine import resolve_device

    args = _parser().parse_args(argv)
    out = out or sys.stdout
    dev = resolve_device(args.device)
    on_cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_cuda else "cpu (plain torch; host times)"
    print(f"# device: {name}", file=out)

    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    codes = np.unique(rng.integers(0, 1 << 62, size=int(args.kmers * 1.01), dtype=np.uint64))[
        : args.kmers
    ]
    table = build_bucket_table(codes, K, row_width=args.row_width)
    meta = (np.arange(table.num_slots, dtype=np.uint64) * 2654435761 & _MASK32).astype(np.uint32)
    rows = torch.from_numpy(table.with_meta(meta)).to(dev)
    print(f"# table: {codes.size} keys, 2^{table.h_bits} buckets x {args.row_width} lanes "
          f"({rows.numel() * 4 / 2**20:.0f} MiB), built {time.perf_counter() - t0:.1f} s",
          file=out)

    q = np.where(
        rng.random((SLICES, args.queries)) < 0.5,
        codes[rng.integers(0, codes.size, size=(SLICES, args.queries))],
        rng.integers(0, 1 << 62, size=(SLICES, args.queries), dtype=np.uint64),
    )
    qhi_np, qlo_np = split_code64_np(q.reshape(-1), K)
    qhi = torch.from_numpy(qhi_np.reshape(SLICES, -1)).to(dev)
    qlo = torch.from_numpy(qlo_np.reshape(SLICES, -1)).to(dev)
    h_bits, salt = table.h_bits, table.salt

    ref_k2 = [_variant("k2", rows, h_bits, salt)(qhi[i], qlo[i]) for i in range(SLICES)]
    ref_plain = [_variant("plain", rows, h_bits, salt)(qhi[i], qlo[i]) for i in range(SLICES)]
    variants = [x.strip() for x in args.variants.split(",")]
    if "k10" in variants:
        t0 = time.perf_counter()
        ct = build_cuckoo(codes, K)
        ctab = torch.from_numpy(ct.table).to(dev)
        cfp = L.cuckoo_fingerprints(ctab)  # the slot fingerprints K10 reads first
        print(f"# cuckoo table: 2 x 2^{ct.h_bits} slots ({ctab.numel() * 4 / 2**20:.0f} MiB), "
              f"built {time.perf_counter() - t0:.1f} s", file=out)

        def key_at(slots: int, slot_of_key: np.ndarray) -> torch.Tensor:
            """Key index held at each slot (-1 where none)."""
            kat = np.full(slots, -1, dtype=np.int64)
            kat[slot_of_key] = np.arange(slot_of_key.size)
            return torch.from_numpy(kat).to(dev)

        key_b, key_c = key_at(table.num_slots, table.slot_of_key), key_at(ct.num_slots, ct.slot_of_key)
        ref_k10 = [L.cuckoo_lookup_plain(ctab, ct.h_bits, ct.salt, qhi[i], qlo[i])
                   for i in range(SLICES)]

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    def chain(fn, n: int):
        """(seconds, checksum) of n lookup steps over the rotated slices."""
        outs = []
        sync()
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t = time.perf_counter()
        for i in range(n):
            outs.append(fn(qhi[i % SLICES], qlo[i % SLICES]))
        if on_cuda:
            end.record()
        sync()
        secs = start.elapsed_time(end) / 1e3 if on_cuda else time.perf_counter() - t
        return secs, sum(_checksum(o[0], o[-1]) for o in outs) & _MASK32

    def k10_vs_k2(got, ref) -> int:
        """Queries whose found flag, or key at a found slot, differ from K2's."""
        (fc, sc), (fb, sb, _) = got, ref
        same_key = key_c[sc.to(torch.int64)] == key_b[sb.to(torch.int64)]
        return int(((fc != fb) | (fb & ~same_key)).sum())

    results: dict = {"device": name, "ok": True}
    for v in variants:
        if v == "k10":
            fn = lambda qh, ql: L.cuckoo_lookup(ctab, ct.h_bits, ct.salt, qh, ql, fp=cfp)  # noqa: E731
        else:
            fn = _variant(v, rows, h_bits, salt)
        got = [fn(qhi[i], qlo[i]) for i in range(SLICES)]
        sync()
        if v == "k10":
            err_k2 = max(k10_vs_k2(g, r) for g, r in zip(got, ref_k2))
            err_plain = max(_max_abs_err(g, r) for g, r in zip(got, ref_k10))
        else:
            err_k2 = max(_max_abs_err(g, r) for g, r in zip(got, ref_k2))
            err_plain = max(_max_abs_err(g, r) for g, r in zip(got, ref_plain))
        chain(fn, N_SHORT)  # warm-up
        d_short, s_short = chain(fn, N_SHORT)
        d_long, s_long = chain(fn, N_LONG)
        linear = (s_short * N_LONG - s_long * N_SHORT) % (1 << 32) == 0 and s_long != 0
        per_step = max((d_long - d_short) / (N_LONG - N_SHORT), 1e-12)
        rate = args.queries / per_step
        results[v] = {"ms": per_step * 1e3, "mlookups_s": rate / 1e6, "err_k2": err_k2,
                      "err_plain": err_plain, "sums": (s_short, s_long), "linear": linear}
        ok = err_k2 == 0 and err_plain == 0 and linear
        results["ok"] &= ok
        print(f"{v:10s}  {per_step * 1e3:9.4f} ms/step  {rate / 1e6:9.2f} M lookups/s  "
              f"sums {s_short}/{s_long}{'' if linear else '  NON-LINEAR'}  "
              f"max_abs_err vs k2 {err_k2}, vs plain {err_plain}"
              + ("" if ok else "  FAILED"), file=out)
    if "k2" in results:
        base = results["k2"]["mlookups_s"]
        for v, r in results.items():
            if isinstance(r, dict) and v != "k2":
                print(f"# {v}: {r['mlookups_s'] / base:.2f}x vs k2", file=out)
    return results


def main(argv: list[str] | None = None) -> int:
    return 0 if bench(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
