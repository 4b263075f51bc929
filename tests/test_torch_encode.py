"""Port parity: ``kmers_tpu_torch.ops.encode.classify_2bit`` against the JAX
package's ``classify_2bit`` and ``ASCII_SKIPPING_LUT``, bit-exact, on all
256 byte values."""

import numpy as np
import pytest
import torch

from kmers_tpu.alphabets import ASCII_SKIPPING_LUT
from kmers_tpu.ops.encode import classify_2bit as jax_classify
from kmers_tpu_torch.ops.encode import classify_2bit

ALL_BYTES = np.arange(256, dtype=np.uint8)


@pytest.fixture(scope="module")
def port():
    codes, certain, ambig = classify_2bit(torch.from_numpy(ALL_BYTES.copy()))
    return codes.numpy(), certain.numpy(), ambig.numpy()


def test_matches_jax_on_every_byte(port):
    codes, certain, ambig = port
    jcodes, jcertain, jambig = (np.asarray(x) for x in jax_classify(ALL_BYTES))
    assert np.array_equal(codes, jcodes.astype(np.int64))
    assert np.array_equal(certain, jcertain)
    assert np.array_equal(ambig, jambig)


def test_classes_of_skipping_lut(port):
    codes, certain, ambig = port
    lut = ASCII_SKIPPING_LUT
    assert np.array_equal(certain, lut < 4)
    assert np.array_equal(ambig, lut == 0xF0)
    assert np.array_equal(codes[certain], lut[certain].astype(np.int64))
