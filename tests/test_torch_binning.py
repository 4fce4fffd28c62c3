"""PyTorch port parity: quantile binning and bit-packed bins
(``spark_ensemble_tpu_torch/ops/binning.py`` vs ``ops/binning.py``).

Thresholds, bin ids and packed words must be array-equal: every split a
tree stores is one of these thresholds, and the fused tier reads the
packed words.  The port keeps packed words as int32 bit patterns of the
JAX package's uint32 words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_ensemble_tpu.ops import binning as jb
from spark_ensemble_tpu_torch.ops import binning as tb


@pytest.mark.parametrize("n,d,B", [(700, 8, 16), (640, 5, 64), (600, 3, 256)])
def test_thresholds_ids_and_packed_words_match(n, d, B):
    rng = np.random.RandomState(B)
    X = rng.randn(n, d).astype(np.float32)
    X[:, 0] = np.round(X[:, 0] * 3)  # heavy ties
    jbins = jb.compute_bins(jnp.asarray(X), B)
    tbins = tb.compute_bins(torch.as_tensor(X), B)
    np.testing.assert_array_equal(
        tbins.thresholds.numpy(), np.asarray(jbins.thresholds)
    )
    jids = jb.bin_features(jnp.asarray(X), jbins)
    tids = tb.bin_features(torch.as_tensor(X), tbins)
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))

    bits = tb.pack_width(B)
    assert bits == jb.pack_width(B)
    jp = jb.pack_bins(jids, B, bits)
    tp = tb.pack_bins(tids, B, bits)
    assert tp.packed.dtype == torch.int32
    np.testing.assert_array_equal(
        tp.packed.numpy(), np.asarray(jp.packed).view(np.int32)
    )
    np.testing.assert_array_equal(tb.unpack_bins(tp).numpy(), np.asarray(jids))


@pytest.mark.parametrize(
    "B,bits", [(12, 4), (16, 4), (200, 8), (256, 8), (500, 32)]
)
def test_pack_unpack_roundtrip(B, bits):
    """Every lane width, feature counts that do and do not fill the last
    word (the JAX package's test_pack_unpack_roundtrip cases)."""
    rng = np.random.RandomState(10)
    assert tb.pack_width(B) == bits
    for d in (1, 7, 8, 16, 17):
        Xb = rng.randint(0, B, size=(53, d)).astype(np.int32)
        cb = tb.pack_bins(torch.as_tensor(Xb), B, bits)
        assert cb.bits == bits and cb.num_features == d
        np.testing.assert_array_equal(tb.unpack_bins(cb).numpy(), Xb)
        np.testing.assert_array_equal(
            cb.packed.numpy(),
            np.asarray(jb.pack_bins(jnp.asarray(Xb), B, bits).packed).view(np.int32),
        )
