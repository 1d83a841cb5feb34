"""The check catches a broken timed path: with each fault of
``faults.FAULTS`` planted under ``Server.step``, a rehearsed run reads
``correct`` false.  (The exchange between chips has no place on one
chip.  At a cell's own size on the card, ``calibrate.py --faults``.)"""
import inspect

import pytest

from repro_torch.models import model as lm

from portbench import faults, port
from portbench.tests.conftest import rehearse, tiny_cell


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_decode_step_is_not_correct(fault):
    # every slot busy, every finished request judged
    cell = tiny_cell(rate=16.0, sample_tokens=10 ** 6)
    assert rehearse(cell, 11)["correct"]
    with port.planted(faults.FAULTS[fault]):
        res = rehearse(cell, 11)
    assert res["correct"] is False
    assert res["checks"]["mean_logit_gap"]["value"] \
        > cell["limits"]["at_most"]["mean_logit_gap"]


def test_planting_puts_the_step_back():
    before = lm.decode_step
    with port.planted(faults.state_unchanged):
        assert lm.decode_step is not before
    assert lm.decode_step is before


def test_decode_step_signature_is_what_the_faults_wrap():
    assert list(inspect.signature(lm.decode_step).parameters)[:5] == \
        ["params", "tokens", "positions", "caches", "cfg"]
