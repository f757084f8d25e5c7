"""Seed 3 of ``test_torch_usergen_fuzz.py``: the plain engine against
cimba_tpu on that user spec."""

from test_torch_usergen_fuzz import check_plain_engine_matches_reference


def test_plain_engine_matches_reference():
    check_plain_engine_matches_reference(3)
