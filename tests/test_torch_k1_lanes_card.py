"""K1's lanes design on the card: a block's matrices, the lanes counters, and
the outputs of a batch that ends part-way through a warp's groups.

A group is n lanes and a warp floor(32/n) groups, so a block of 128 threads
holds 4 floor(32/n) matrices, and one launch on B matrices fills B*n lanes
(``lanes.matrix_lanes``) of the blocks' 128 it launches
(``lanes.launched_lanes``).  Each test is marked ``card``: it needs a CUDA
card and skips without one (decided in the ``card`` fixture).  The file
imports no JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -m card tests/test_torch_k1_lanes_card.py -q
"""

import numpy as np
import pytest
import torch

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.ops import fused_inverse
from matrix_inversion_tpu_torch.utils import profiling

# (HIGH's n, tracked, matrices a block)
CASES = [(10, False, 12), (9, False, 12), (6, True, 20), (12, False, 8)]
BATCH = 1_001  # ends part-way through a warp's groups at n = 9, 10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n,track,per_block", CASES,
                         ids=[f"high{n}{'_tracked' * t}" for n, t, _ in CASES])
def test_lanes_counters_and_matrices_a_block(card, n, track, per_block):
    p = mt.HIGH.replace(n=n)
    config = (n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    assert fused_inverse.design_of(n, track) == "lanes"
    assert fused_inverse.mats_per_block(config + (track,)) == per_block
    assert fused_inverse.block_threads(config + (track,)) == 128
    rng = np.random.RandomState(n)
    mags, signs = float_matrix_to_mags_and_signs(rng.randn(BATCH, n, n) * 100, *config[1:4])
    m, s = torch.from_numpy(mags), torch.from_numpy(signs)
    before = profiling.counters("lanes.")
    got = fused_inverse.fused_matrix_inverse(m.to(card), s.to(card), *config, track=track)
    torch.cuda.synchronize(card)
    after = profiling.counters("lanes.")
    filled, launched = (after[k] - before.get(k, 0)
                        for k in ("lanes.matrix_lanes", "lanes.launched_lanes"))
    blocks = -(-BATCH // per_block)
    assert (filled, launched) == (BATCH * n, blocks * 128)
    want = fused_inverse.fused_matrix_inverse_reference(m, s, *config, track=track)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
