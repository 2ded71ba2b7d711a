"""torch twins of mix32 / cuckoo_slots vs the numpy uint32 originals
(exact), on inputs at and above 2**31 where signed arithmetic would go
wrong."""

import numpy as np
import pytest
import torch

from strainer2_tpu.index.hashing import cuckoo_slots, mix32
from strainer2_tpu_torch.index.hashing import cuckoo_slots_torch, mix32_torch


def _u32(rng, n):
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, (1 << 31) - 1, 1 << 31, 0xFFFFFFFF]
    x[4 : n // 2] |= np.uint32(1 << 31)  # half the inputs >= 2**31
    return x


def test_mix32_torch_matches_numpy():
    x = _u32(np.random.default_rng(0), 100_000)
    got = mix32_torch(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, mix32(x).astype(np.int64))


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("h_bits", [4, 21, 27, 32])
def test_cuckoo_slots_torch_matches_numpy(h_bits, which):
    rng = np.random.default_rng(h_bits * 2 + which)
    hi, lo = _u32(rng, 50_000), _u32(rng, 50_000)
    got = cuckoo_slots_torch(
        torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64)), h_bits, which
    ).numpy()
    np.testing.assert_array_equal(got, cuckoo_slots(hi, lo, h_bits, which).astype(np.int64))
