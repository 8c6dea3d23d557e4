"""The splits over ``torch.distributed`` on CPU processes with gloo: the
mesh, ``shard_state``, the split particle-filter boundaries, the
particle-split step and the robots split, each against one process.

The ranks are spawned by ``mcl_3dl_tpu_torch.tools.sharded.spawn`` (a
``file://`` store under ``tmp_path``, gloo on the loopback); they import
the port only.  Each test joins its ranks within 60 s, so that a hang
fails the test.

Tolerances and why:
* ``pf.expectation`` atol 1e-5 (JAX's ``test_sharding``): sums split over
  ranks add in another order;
* ``pf.resample``/``resize``: the weights are given, so the gathered CDF
  is the one-process CDF: positions atol 1e-5, weights equal;
* the split step: tiers 0/0 on every rank; ``e_pos``/``e_rot`` atol 1e-5
  and ``cov`` rtol 1e-3 (``test_torch_engine``'s tolerances); the measured
  weights within 1e-5 of the largest against one process scoring the
  same slices (sums split over ranks add in another order); the
  resampled slice bit-equal to one-process
  ``pf.resample`` on the split's own gathered weights and the same draws;
  against the one-process step, resampled positions atol 1e-5 except
  where a comb tooth falls between the two processes' CDFs, which must
  be few (at most 5% of a slice);
* the robots split: bit-equal to the one-process fleet (each robot runs
  the same single-robot step on the same draws).
"""

import pytest

from mcl_3dl_tpu_torch.tools import sharded

TIMEOUT = 60.0


def test_mesh_axes(tmp_path):
    res = sharded.spawn("mesh", 4, tmp_path, timeout=TIMEOUT)
    for r, m in enumerate(res):
        assert m["axis_names"] == ["robots", "particles"]
        assert m["shape"] == [1, 4] and m["index"] == [0, r]
        assert m["shape2"] == [2, 2] and m["index2"] == [r // 2, r % 2]
        assert "not divisible by 3 robot groups" in m["errors"][0]
        assert "needs a world of 5 ranks" in m["errors"][1]


def test_shard_state_and_pf_boundaries(tmp_path):
    res = sharded.spawn("state", 4, tmp_path, timeout=TIMEOUT)
    for m in res:
        assert m["roundtrip"], m
        assert m["mean_err"] <= 1e-5, m
        assert m["resample_err"] <= 1e-5 and m["resample_prob_equal"], m
        assert m["resize_err"] <= 1e-5 and m["resize_prob_equal"], m
        assert m["best_equal"], m


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_one_process(tmp_path, world):
    res = sharded.spawn("step", world, tmp_path, timeout=TIMEOUT)
    for m in res:
        assert sharded.check(m) == [], m
        assert m["ref_tiers"] == [0, 0], m
        assert m["pub_pos_err"] <= 1e-5, m
        assert m["resampled_equal"] and m["entropy_equal"], m
        assert m["resampled_moved"] <= m["capacity"] // world // 20, m
    # every rank publishes the same pose
    assert all(m["e_pos"] == res[0]["e_pos"] for m in res)


def test_robots_split_matches_one_process(tmp_path):
    res = sharded.spawn("robots", 2, tmp_path, timeout=TIMEOUT)
    assert [m["robot_offset"] for m in res] == [0, 2]
    for m in res:
        assert m["equal"], m
        assert m["tiers"] == [0, 0, 0, 0], m
    pubs = [p for m in res for p in m["pub_pos"]]
    assert all(abs(a[0] - b[0]) > 0.1 for a, b in zip(pubs, pubs[1:]))
