"""Port parity: bit packing is array-equal to the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro_torch.core import bitpack


@pytest.mark.parametrize("L", [1, 7, 8, 9, 13, 64, 65])
def test_pack_unpack_match_reference(L):
    rng = np.random.default_rng(L)
    bits = rng.random((5, 3, L)) < 0.5
    want = np.asarray(jbitpack.pack_bits(jnp.asarray(bits)))
    got = bitpack.pack_bits(torch.from_numpy(bits)).numpy()
    assert bitpack.packed_width(L) == jbitpack.packed_width(L) == want.shape[-1]
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    back = bitpack.unpack_bits(torch.from_numpy(got), L).numpy()
    np.testing.assert_array_equal(back, np.asarray(jbitpack.unpack_bits(jnp.asarray(want), L)))
    np.testing.assert_array_equal(back, bits)


def test_unpack_rejects_too_few_words():
    with pytest.raises(ValueError, match="cannot hold"):
        bitpack.unpack_bits(torch.zeros((2, 1), dtype=torch.uint8), 9)
