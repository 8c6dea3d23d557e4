"""The control on the card, at a size a test run holds: each cell's run
with the bfloat16 control read beside the program, at 65,536 particles
(the fleet: 8 robots) and a 3 s window.  The program's numbers keep to
the cell's limits; the control's fail at least one of the position, the
covariance and the entropy, and the control does not pass as correct.  The
readings that set the limits were taken at the cells' own sizes
(``run.py --control``; PERF.md).  Skipped without a CUDA device:

    python -m pytest -p no:cacheprovider benchmark/tests/test_control_card.py
"""

import pytest
import torch

from benchmark import harness, run

# the numbers the control's bfloat16 models move (its draws are float32)
MODELS = ("pose_gap_m", "cov_gap", "entropy_gap")
SIZES = {
    "flagship-1M.tracking": {"params": {"num_particles": 65536},
                             "model": {"num_particles": 65536}},
    "flagship-1M.relocalize": {"params": {"num_particles": 65536},
                               "model": {"num_particles": 65536}},
    "fleet-1024x10k.tracking": {"robots": 8},
}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_fails_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    limits = harness.limits(cell)
    out, checks, ctl = run.run_cell(cell, 2 ** 31 + 99, 3.0, 0,
                                    overrides=SIZES[cell], control=True,
                                    log=lambda m: None)
    assert out["correct"], checks
    assert not ctl["correct"], ctl
    assert any(ctl[k] > limits[k] for k in MODELS), ctl
