"""K1 at n = 2, the closed form adj(M)/det(M): its counter.

Each K1 launch at n = 2 adds its B matrices to ``k1.closed_form_matrices``,
tracked or not; a launch at any other n, and any launch of the lanes design
(which takes n >= 3), adds nothing.  On the CPU the rule is held on
``ops/fused_inverse.py::_launch`` with the library's launch function, the
card's device scope and its stream stubbed.  The tests marked ``card``
need a CUDA card and skip without one (decided in the ``card`` fixture);
they run the main path, ``run_raw`` at HIGH n = 2 on 4,194,304 matrices.
The file imports no JAX, so on the card it runs without the suite's
conftest:

    python -m pytest --noconftest -m card tests/test_torch_k1_closed_form.py -q
"""

import contextlib

import numpy as np
import pytest
import torch

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.ops import fused_inverse
from matrix_inversion_tpu_torch.utils import profiling

COUNTER = "k1.closed_form_matrices"
BATCH = 37
# (n, tracked, design, a block's (threads, matrices) for the lanes design)
LAUNCHES = [(2, False, "straight_line", None), (2, True, "straight_line", None),
            (3, False, "straight_line", None), (4, False, "straight_line", None),
            (4, True, "straight_line", None), (3, False, "lanes", (128, 40)),
            (10, False, "lanes", (128, 12)), (6, True, "lanes", (128, 20))]


@pytest.fixture
def stubbed_card(monkeypatch):
    """The launch's device scope and stream, stubbed for CPU tensors."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())


@pytest.mark.parametrize("n,track,design,per_block", LAUNCHES,
                         ids=[f"{d}_n{n}{'_tracked' * t}" for n, t, d, _ in LAUNCHES])
def test_a_launch_counts_its_matrices_at_n2_only(stubbed_card, n, track, design, per_block):
    m = torch.zeros(BATCH, n * n, dtype=torch.int64)
    launched = []
    profiling.reset()
    out = fused_inverse._launch(lambda *args: launched.append(args) or 0, per_block, m,
                                torch.zeros_like(m), n, BATCH, track, design)
    assert len(launched) == 1 and len(out) == 2 + track
    assert profiling.counters("k1.") == ({COUNTER: BATCH} if n == 2 else {})
    assert profiling.launches(fused_inverse._COUNTERS[design, track][len("launch."):]) == 1
    # a second launch adds its own batch
    fused_inverse._launch(lambda *args: 0, per_block, m[:5], torch.zeros_like(m[:5]), n, 5,
                          track, design)
    assert profiling.counters("k1.") == ({COUNTER: BATCH + 5} if n == 2 else {})


def test_a_refused_launch_counts_nothing(stubbed_card):
    m = torch.zeros(BATCH, 4, dtype=torch.int64)
    profiling.reset()
    with pytest.raises(RuntimeError, match="cudaError 1"):
        fused_inverse._launch(lambda *args: 1, None, m, torch.zeros_like(m), 2, BATCH, False,
                              "straight_line")
    assert profiling.counters() == {}


def test_the_plain_version_runs_no_launch_and_counts_nothing():
    p = mt.HIGH.replace(n=2)
    inv = mt.BatchedMatrixInversion(p, 8, backend="packed", io="packed", device="cpu")
    profiling.reset()
    inv.run_raw(*inv.quantize(np.random.default_rng(2).standard_normal((8, 2, 2)) * 100))
    assert profiling.counters("k1.") == {} and profiling.launches("fused_inverse") == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run on the card")
    return torch.device("cuda", 0)


CARD_BATCH = 4_194_304  # the high_n2.device cell's batch
CHECKED = 4_096


@pytest.mark.card
@pytest.mark.parametrize("track", [False, True], ids=["untracked", "tracked"])
def test_run_raw_on_the_card_counts_every_matrix_once(card, track):
    """``run_raw`` at HIGH n = 2, packed I/O, on the cell's batch: one K1
    launch a call, ``k1.closed_form_matrices`` up by the batch each call,
    and the first matrices' outputs (flags too) == the plain version."""
    p = mt.HIGH.replace(n=2)
    floats = np.random.default_rng(26).standard_normal((CARD_BATCH, 2, 2)) * 100
    inv = mt.BatchedMatrixInversion(p, CARD_BATCH, backend="packed", io="packed",
                                    device=card, track_overflow=track)
    args = inv.quantize(floats)
    for call in (1, 2):
        before = profiling.counters()
        got = inv.run_raw(*args)
        torch.cuda.synchronize(card)
        after = profiling.counters()
        grew = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        kernel = "launch.fused_inverse" + "_tracked" * track
        assert grew.get(COUNTER) == CARD_BATCH and grew.get(kernel) == 1, (call, grew)
        assert not {k for k in grew if k.startswith("launch.")} - {kernel}
    config = (2, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    mags, signs = float_matrix_to_mags_and_signs(floats[:CHECKED], *config[1:4])
    want = fused_inverse.fused_matrix_inverse_reference(
        torch.from_numpy(mags), torch.from_numpy(signs), *config, track=track)
    for g, w in zip(got, want):
        assert torch.equal(g[:CHECKED].cpu().reshape(w.shape), w)
