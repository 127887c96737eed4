"""The reference's closed form at n = 2, tracked: ``circuit.inverse_2x2``
computes adj(M)/det(M) with two products widened to (2 ints + 3, 2 ints)
digits, one reciprocal of the determinant into 0 integer digits and four
multiplies, as K1's straight-line tracked body does on the card.  Its
overflow flags are held matrix by matrix to the program's tracked closed form
on the CPU, by the same check as the LU sizes of
``test_gpubench_reference.py``: at HIGH on scaled matrices, and at LOW on
normal(0, 100) ones, of which a tenth or more overflow."""

import pytest

import test_gpubench_reference as reference_tests


@pytest.mark.parametrize("preset,make", [("high", reference_tests._scaled),
                                         ("low", reference_tests._matrices)],
                         ids=lambda v: getattr(v, "__name__", v))
def test_reference_flags_equal_the_programs_tracked_flags_at_n2(preset, make):
    reference_tests.test_reference_flags_equal_the_programs_tracked_flags(preset, 2, make)
