"""Plain torch canonical_windows (the CPU side of kernel K1) vs the jnp
function and the Pallas kernel (interpret mode), exactly, where valid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strainer2_tpu.ops.packing import canonical_windows as jnp_canonical_windows
from strainer2_tpu.ops.packing_np import canonical_codes_np, merge_code64_np
from strainer2_tpu.ops.pallas_kernels import canonical_windows_pallas
from strainer2_tpu_torch.ops.packing import canonical_windows
from tests.oracle import random_dna, seq_to_base_codes


def _batch(rng, k, rows=16, length=512, n_prob=0.03):
    bases = np.full((rows, length), 4, dtype=np.uint8)
    for r in range(rows):
        s = seq_to_base_codes(random_dna(rng, int(rng.integers(k, length)), n_prob=n_prob))
        bases[r, : s.size] = s
    return bases


@pytest.mark.parametrize("k", [15, 20, 31])
def test_plain_canonical_windows_matches_jnp_and_pallas(k):
    bases = _batch(np.random.default_rng(k), k)
    hi, lo, valid = canonical_windows(torch.from_numpy(bases), k)
    hi, lo, valid = hi.numpy(), lo.numpy(), valid.numpy()
    ref = jnp_canonical_windows(jnp.asarray(bases), k)
    mask = np.asarray(ref.valid)
    np.testing.assert_array_equal(valid, mask)
    np.testing.assert_array_equal(hi[mask], np.asarray(ref.hi)[mask])
    np.testing.assert_array_equal(lo[mask], np.asarray(ref.lo)[mask])

    p_hi, p_lo, p_valid = canonical_windows_pallas(jnp.asarray(bases), k)
    np.testing.assert_array_equal(np.asarray(p_valid).astype(bool), valid)
    np.testing.assert_array_equal(np.asarray(p_hi)[mask], hi[mask])
    np.testing.assert_array_equal(np.asarray(p_lo)[mask], lo[mask])


@pytest.mark.parametrize("k", [1, 16, 17, 32])
def test_plain_canonical_windows_edge_k_matches_host_twin(k):
    """k = 32 fills all 64 code bits, where a signed compare would fail."""
    rng = np.random.default_rng(100 + k)
    bases = _batch(rng, k, rows=4, length=200)
    hi, lo, valid = (x.numpy() for x in canonical_windows(torch.from_numpy(bases), k))
    for r in range(bases.shape[0]):
        codes, ok = canonical_codes_np(bases[r], k)
        np.testing.assert_array_equal(valid[r], ok)
        np.testing.assert_array_equal(merge_code64_np(hi[r], lo[r], k)[ok], codes[ok])


def test_engine_extract_codes_matches_jax_engine():
    from strainer2_tpu.pipeline.engine import KmerEngine
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    bases = _batch(np.random.default_rng(9), 31, rows=16, length=256, n_prob=0.05)
    np.testing.assert_array_equal(
        TorchKmerEngine(31, device="cpu").extract_codes(bases),
        KmerEngine(31, layout="bucket").extract_codes(bases),
    )


@pytest.mark.parametrize(
    "shape,k", [((4, 40), 0), ((4, 40), 33), ((4, 20), 31), ((40,), 31)]
)
def test_canonical_windows_rejects_bad_input(shape, k):
    with pytest.raises(ValueError):
        canonical_windows(torch.zeros(shape, dtype=torch.uint8), k)
