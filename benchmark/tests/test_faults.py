"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell on the CPU at a small size (the
harness's look for a card skipped) with one fault planted in the
program's step, ``MCL3DL._step``, which every cell's window drives, and
sees ``correct`` false; the same run without a fault comes out correct.
The faults a localizer's cell can have:

* the step returns its state unchanged (the particles are never
  updated);
* half of the batch left out, its answers taken from the rest: every
  second step returns the step before it (in the fleet, every second
  robot gets its neighbour's answer and state);
* an answer altered where it is produced: the published position moved
  by 1 cm;
* an answer lost where it is produced: every step after the first
  publishes a position that is not a number, which ``failed`` counts.

A run whose compared numbers all keep to their limits is still not
correct when an update it did not sample failed.

The cells run on one card, so there is no exchange between cards to
leave out.  The limits are the tolerances of ``test_harness_reference``.
"""

import pytest

from benchmark import check, harness, run
from benchmark.tests.test_harness_reference import SMALL, SMALL_FLEET, SOUND

CELLS = {
    "flagship-1M.tracking": (SMALL, {"warmup_scans": 2}),
    "fleet-1024x10k.tracking": (SMALL_FLEET, {"warmup_steps": 1}),
}


def unchanged(step):
    def broken(self, state, *a, **k):
        return (state, *step(self, state, *a, **k)[1:])
    return broken


def half_left_out(step):
    calls = []

    def broken(self, *a, **k):
        calls.append(calls[-1] if len(calls) % 2 else step(self, *a, **k))
        return calls[-1]
    return broken


def altered(step):
    def broken(self, *a, **k):
        out = step(self, *a, **k)
        aux = dict(out[5], pub_pos=out[5]["pub_pos"] + 0.01)
        return (*out[:5], aux)
    return broken


def lost(step):
    calls = []

    def broken(self, *a, **k):
        out = step(self, *a, **k)
        calls.append(None)
        if len(calls) == 1:
            return out
        aux = dict(out[5], pub_pos=out[5]["pub_pos"] * float("nan"))
        return (*out[:5], aux)
    return broken


def _run(cell):
    small, mix = CELLS[cell]
    out, checks, _ = run.run_cell(cell, 2 ** 31 + 777, 0.5, 0, device="cpu",
                                  overrides=small, mix_overrides=mix,
                                  limits=SOUND, log=lambda m: None)
    return out, checks


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    out, checks = _run(cell)
    assert out["correct"], checks
    bench = harness.load_benchmark(harness.HERE.parent)
    names = {m["name"] for m in harness.end_to_end_for(bench, cell)}
    # a window of one or two scans has no 95th percentile
    assert names - {"update_p95_ms"} <= set(out["metrics"]) <= names


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered, lost],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_caught(cell, fault, monkeypatch):
    from mcl_3dl_tpu_torch.engine import MCL3DL
    monkeypatch.setattr(MCL3DL, "_step", fault(MCL3DL._step))
    out, checks = _run(cell)
    assert not out["correct"], checks
    if fault is lost:
        assert out["failed"] > 0


def test_a_failed_update_fails_the_run():
    within = {k: 0.0 for k in SOUND}
    assert check.verdict(10, 0, within, SOUND)
    assert not check.verdict(10, 1, within, SOUND)
    assert not check.verdict(0, 0, within, SOUND)
    assert not check.verdict(10, 0, dict(within, pose_gap_m=None), SOUND)
