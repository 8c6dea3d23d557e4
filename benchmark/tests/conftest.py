"""The benchmark's own tests (not collected by the repository's
``pytest tests/``): ``python -m pytest benchmark/tests`` from the
repository root.  Tests marked ``card`` need a CUDA device and skip
without one, deciding inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")
