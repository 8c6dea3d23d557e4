"""The roofline counts tied to the bounds PERF.md's kernel table gives at
the same shapes (bytes over 3.35 TB/s against f32 operations over 67
TFLOP/s, whichever is longer).

* M2 at 1M particles x 3 beams on the flagship room's field: 0.0538 ms.
* K1 at 1M particles x 96 points x 97 bins: 0.0590 ms, the table's
  7,225 live (point, bin) tables; the count without tables and with
  every table given to the launch lie on either side.
* K1 at a fleet robot (10,240 particles, 7 bins): 17 tiles, as the table
  has it.
"""

import pytest

from benchmark import check, harness, traffic

MS = 1e3


@pytest.fixture(scope="module")
def field_cells():
    return check.field_cells(traffic.world_map(),
                             harness.config("flagship-1M")["model"])


def test_m2_at_1m_by_3_rays(field_cells):
    m2 = harness.roofline("m2")
    shapes = dict(particles=1 << 20, beam_points=3, field_cells=field_cells)
    assert harness.bound_s(*m2.launch(shapes)) * MS == pytest.approx(
        0.0538, abs=5e-5)


def test_k1_at_1m_by_96():
    k1 = harness.roofline("k1")
    shapes = dict(particles=1 << 20, like_points=96, bins=97)
    assert harness.bound_s(*k1.launch(shapes)) * MS == pytest.approx(
        0.0590, abs=5e-5)
    assert harness.bound_s(*k1.count(1 << 20, 96, 97, 7225)) * MS \
        == pytest.approx(0.0590, abs=5e-5)
    bare = harness.bound_s(*k1.count(1 << 20, 96, 97, 0)) * MS
    every = harness.bound_s(*k1.count(1 << 20, 96, 97, 96 * 97)) * MS
    assert bare < 0.0590 < every


def test_k1_fleet_robot_tiles():
    k1 = harness.roofline("k1")
    assert k1.tiles(10240, 7) == 17
    assert k1.tiles(1 << 20, 97) == 1121


def test_bound_takes_the_longer_of_bytes_and_operations():
    assert harness.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert harness.bound_s(0, 67e12) == pytest.approx(1.0)
    assert harness.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
