"""The plain reference against the port at a tiny size, the byte counts,
and the import rules."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import torch

from conftest import PB, ROOT

from pbcore import bytecount, harness, reference
from pbcore.reference import Stats


def test_window_codes_match_the_port():
    from strainer2_tpu_torch.ops.packing_np import canonical_codes_np

    r = np.random.default_rng(3)
    seq = r.integers(0, 4, 400).astype(np.uint8)
    seq[r.integers(0, 400, 6)] = 4
    codes, valid = reference.window_codes(torch.from_numpy(seq)[None, :], 31)
    want, ok = canonical_codes_np(seq, 31)
    assert np.array_equal(valid[0].numpy(), ok)
    assert np.array_equal(codes[0].numpy()[ok].astype(np.uint64), want[ok])


def test_printed_order_matches_the_port_through_doublings():
    from strainer2_tpu_torch.index.refhash_order import djb2_codes, reference_row_order

    r = np.random.default_rng(4)
    codes = np.unique(r.integers(0, 1 << 62, 5000, dtype=np.uint64))
    r.shuffle(codes)
    hashes = reference.djb2(torch.from_numpy(codes.astype(np.int64)), 31).numpy()
    assert np.array_equal(hashes, djb2_codes(codes, 31).astype(np.int64))
    for cap in (16, 1000, 8_000_000):
        assert np.array_equal(reference.printed_order(hashes, cap),
                              reference_row_order(codes, 31, cap))


def test_format_rows():
    rows = reference.format_rows([b"x\t", np.array([0, 7, 12345678901]), b"\t",
                                  np.array([[65, 67], [71, 84], [84, 71]], np.uint8), b"\n"])
    assert rows == b"x\t0\tAC\nx\t7\tGT\nx\t12345678901\tTG\n"


def test_byte_counts():
    st = Stats(bases=1000, reads=10, valid=700, hits=30)
    assert bytecount.classify_bytes(st) == 1000 + 40 + 32 * 700 + 80
    assert bytecount.classify_bytes(st, 32) == 1000 + 40 + 32 * 700 + 8 * 32 * 10
    assert bytecount.count_bytes(st) == 1000 + 32 * 700 + 32 * 30
    cohort = SimpleNamespace(inputs=SimpleNamespace(strains=[None] * 32))
    drivers = {d: harness.load(os.path.join(PB, "drivers", f"{d}.py"), f"bytes_{d}")
               for d in ("strain_detector", "multi_strain_detector", "scrub_count")}
    assert drivers["strain_detector"].step_bytes(st, None) == bytecount.classify_bytes(st)
    assert drivers["multi_strain_detector"].step_bytes(st, cohort) == \
        bytecount.classify_bytes(st, 32)
    assert drivers["scrub_count"].step_bytes(st, None) == bytecount.count_bytes(st)


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "strainer2_tpu_torchx", sys)
    assert harness.banned_modules() == [] or "jax" in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "strainer2_tpu.pipeline", sys)
    assert "strainer2_tpu" in harness.banned_modules()


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r, %r]; import pbcore.reference, pbcore.harness; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'strainer2_tpu', 'strainer2_tpu_torch'}); "
            "print(bad); sys.exit(1 if bad else 0)") % (PB, ROOT)
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
