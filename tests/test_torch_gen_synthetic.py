"""Port: tools/torch_gen_synthetic.py against the JAX package's
tools/gen_synthetic.py, on the CPU.

* ``write_rows`` writes the JAX tools' ``_write`` bytes: ids past 4 digits,
  values past 9.9999, labels over 1, both formats; ids of every digit
  count up to 2^31 - 1, each at its edges; and it refuses values off the
  4-decimal grid and negative numbers.
* ``generate`` writes ``gen_synthetic.generate``'s file for the shapes the
  port's tools and chip_smoke.py ask for (blocks smaller than the file, so
  the row blocks of the score and of the text are both exercised), and the
  command line is gen_synthetic.py's.
"""

import filecmp

import numpy as np
import pytest

from tools import gen_synthetic
from tools import quality_zoo as jzoo
from tools import torch_gen_synthetic as gen


def test_write_rows_is_the_jax_write_on_wide_values(tmp_path, monkeypatch):
    monkeypatch.setattr(gen, "WRITE_CHUNK", 700)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 1 << 20, size=(3000, 5))
    vals = np.round(rng.uniform(0, 40, size=(3000, 5)), 4).astype(np.float32)
    labels = rng.integers(0, 12, size=3000)
    for fmt in ("libsvm", "libffm"):
        jzoo._write(str(tmp_path / "j"), labels, ids, vals, fmt)
        gen.write_rows(str(tmp_path / "p"), labels, ids, vals, fmt)
        assert filecmp.cmp(tmp_path / "j", tmp_path / "p", shallow=False)
    # Every digit count up to a 2^31 - 1 vocabulary's ids, each at its edges.
    edges = np.array([0, 2**31 - 1] + [10**p + d for p in range(1, 10) for d in (-1, 0)])
    wide = rng.permutation(np.resize(edges, ids.size)).reshape(ids.shape)
    gen.write_rows(str(tmp_path / "p"), labels, wide, vals, "libsvm")
    jzoo._write(str(tmp_path / "j"), labels, wide, vals, "libsvm")
    assert filecmp.cmp(tmp_path / "j", tmp_path / "p", shallow=False)
    with pytest.raises(ValueError, match="4 decimals"):
        gen.write_rows(str(tmp_path / "p"), labels, ids, vals + np.float32(1e-3 / 3), "libsvm")
    with pytest.raises(ValueError, match="non-negative"):
        gen.write_rows(str(tmp_path / "p"), labels, -ids, vals, "libsvm")


# (fields, vocab, extra generate kwargs): baseline5's files, the zoo's avazu
# file, baseline2's, tiered_big's 2^31 - 1 vocabulary, the study's task.
SHAPES = {
    "baseline5": (11, 1 << 20, dict(seed=7)),
    "avazu_libffm_binary": (22, 1 << 20, dict(fmt="libffm", binary_vals=True, seed=5)),
    "baseline2": (39, 1 << 24, dict(seed=3)),
    "vocab_2_31": (11, 2**31 - 1, dict(seed=11)),
    "study": (39, 1 << 14, dict(seed=1, factor_num=4, spread=3.0)),
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_generate_writes_gen_synthetics_file(tmp_path, monkeypatch, shape):
    monkeypatch.setattr(gen, "WRITE_CHUNK", 500)
    monkeypatch.setattr(gen, "SCORE_CHUNK", 700)
    fields, vocab, kw = SHAPES[shape]
    gen.generate(str(tmp_path / "p"), 1800, fields, vocab, **kw)
    gen_synthetic.generate(str(tmp_path / "j"), 1800, fields, vocab, **kw)
    assert filecmp.cmp(tmp_path / "p", tmp_path / "j", shallow=False)


def test_command_line_is_gen_synthetics(tmp_path, capsys):
    args = ["--rows", "900", "--fields", "22", "--vocab", "65536", "--format", "libffm",
            "--binary-vals", "--seed", "6", "--model-seed", "99", "--spread", "2.0",
            "--factor-num", "3"]
    assert gen.main([*args, "--out", str(tmp_path / "sub" / "p")]) == 0
    want = gen_synthetic.main([*args, "--out", str(tmp_path / "sub" / "j")])
    assert want == 0
    assert filecmp.cmp(tmp_path / "sub" / "p", tmp_path / "sub" / "j", shallow=False)
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line[:-1] + "p"
