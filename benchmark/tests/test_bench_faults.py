"""The check sees faults planted underneath the timed path: a step that
returns its state unchanged, half of the batch left unsolved, and an answer
altered where it is produced. Each run reads ``correct`` false."""
from __future__ import annotations

import pytest

from benchmark.tests import faults
from benchmark.tests._cells import execute


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_on_one_card(fault, monkeypatch):
    faults.apply(fault, monkeypatch.setattr)
    out, lines = execute("rocket.track.b1024", CHECK_LANES=4)
    assert not out["correct"], lines
