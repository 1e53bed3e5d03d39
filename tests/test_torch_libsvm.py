"""Port: host parsing and hashing give the JAX package's output and errors.

fast_tffm_tpu_torch keeps its own copies of ``parse_lines``,
``hash_feature_id`` and the width scan; a drift from the JAX package's would
map the same request to different table rows in the two packages.
"""

import os

import numpy as np
import pytest

from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.data.hashing import fnv1a64 as jax_fnv1a64
from fast_tffm_tpu.data.hashing import hash_feature_id as jax_hash_feature_id
from fast_tffm_tpu.data.libsvm import parse_lines as jax_parse_lines
from fast_tffm_tpu.training import scan_max_nnz as jax_scan_max_nnz
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.data.hashing import fnv1a64, hash_feature_id
from fast_tffm_tpu_torch.data.libsvm import parse_lines, scan_max_nnz

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
LINES = [
    "1 3:0.5 9:1.25 40:0.75",
    "0 7:1",
    "-1 2:0.5 5:2.0",
    "+1 11:1e-3 12:3.5 13:-0.25 14:1",
    "1 0:1:0.5 2:17:1.0 1:99:0.25",  # libffm field:feat:val
    "0.5 63:1e40",  # positive fractional label; huge value overflows to inf
]


@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("max_nnz", [None, 6])
def test_parse_lines_matches_jax(hashed, max_nnz):
    kw = dict(vocabulary_size=128, hash_feature_id_flag=hashed, max_nnz=max_nnz)
    got, want = parse_lines(LINES, **kw), jax_parse_lines(LINES, **kw)
    for name in ("labels", "ids", "vals", "fields", "nnz"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.batch_size, got.max_nnz) == (want.batch_size, want.max_nnz)


@pytest.mark.parametrize(
    "lines,kw",
    [
        (["1 3:0.5", ""], {}),  # empty line
        (["x 3:0.5"], {}),  # bad label
        (["1 3:0.5:1:2"], {}),  # too many colons
        (["1 3"], {}),  # no value
        (["1 a:0.5"], {}),  # non-numeric id without hashing
        (["1 3:abc"], {}),  # bad value
        (["1 500:1"], {}),  # id out of range
        (["1 -1:1"], {}),  # negative id
        (["1 1:1 2:1 3:1"], {"max_nnz": 2}),  # wider than max_nnz
    ],
)
def test_parse_errors_match_jax(lines, kw):
    kw = dict(vocabulary_size=128, **kw)
    with pytest.raises(ValueError) as want:
        jax_parse_lines(lines, **kw)
    with pytest.raises(ValueError) as got:
        parse_lines(lines, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("token", ["", "0", "12345", "user=42", "ünïcode", b"\x00\xff"])
def test_hashing_matches_jax(token):
    raw = token.encode() if isinstance(token, str) else token
    assert fnv1a64(raw) == jax_fnv1a64(raw)
    for vocab in (1, 97, 1 << 20, 2**31 - 1):
        assert hash_feature_id(token, vocab) == jax_hash_feature_id(token, vocab)


@pytest.mark.parametrize("max_nnz", [0, 7])
def test_width_scan_matches_jax(max_nnz):
    files = dict(
        train_files=(os.path.join(DATA, "train.libsvm"),),
        validation_files=(os.path.join(DATA, "test.libsvm"),),
    )
    got = scan_max_nnz(Config(max_nnz=max_nnz, **files))
    assert got == jax_scan_max_nnz(JaxConfig(max_nnz=max_nnz, **files))
