"""The control, kept at a size a test run holds: the reference computed
in float8 in the program's place reads a wider mean gap than the program on
every seed, and fails a limit that the program's runs meet.  (At the
cells' own sizes the readings and limits are in ``cells/`` and
``PERF.md``, read on the card by ``calibrate.py``.)"""
import pytest

from portbench import check
from portbench.tests.conftest import TINY_LIMIT, serve_tiny, tiny_cfg


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_where_the_program_passes(seed):
    w, finished = serve_tiny(seed)
    r = check.gaps(w, tiny_cfg(), *check.pick(finished, seed, 64, 16), "cpu",
                   control=True)
    assert r["mean_logit_gap"] <= TINY_LIMIT < r["control_mean_logit_gap"]
