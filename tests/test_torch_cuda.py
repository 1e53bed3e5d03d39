"""Port kernels on the card: each CUDA kernel against its plain PyTorch version.

Needs a CUDA device and nvcc; elsewhere every test skips.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (the repository's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.ops.anova import MAX_ORDER, anova_inter, anova_inter_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "b,n,k,order",
    [
        (1, 11, 8, 3),
        (512, 11, 8, 4),
        (130, 7, 5, 3),  # ragged: shared-memory reduction, partial last block
        (33, 4, 40, 5),  # k above a warp
        (9, 3, 300, 3),  # k above a block: a thread walks several factors
        (64, 12, 1, 8),
        (17, 0, 8, 3),  # no features: every degree >= 1 is 0
    ],
)
def test_anova_kernel_matches_plain(cuda, b, n, k, order):
    rng = np.random.default_rng(b * 1000 + n * 10 + order)
    z = torch.from_numpy((rng.normal(size=(b, n, k)) * 0.4).astype(np.float32)).to(cuda)
    before = anova_inter.launches
    got = anova_inter(z, order)
    torch.cuda.synchronize()
    assert anova_inter.launches == before + 1
    torch.testing.assert_close(got, anova_inter_plain(z, order), rtol=1e-5, atol=1e-6)


def test_anova_kernel_refuses_what_it_does_not_take(cuda):
    z = torch.zeros((4, 3, 8), device=cuda)
    with pytest.raises(ValueError):
        anova_inter(z, MAX_ORDER + 1)
    with pytest.raises(ValueError):
        anova_inter(z.transpose(0, 1), 3)  # not contiguous
    with pytest.raises(ValueError):
        anova_inter(z.double(), 3)
