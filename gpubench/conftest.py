"""The benchmark's own tests (python -m pytest gpubench/tests from the
repository's root).  Tests marked ``card`` need a CUDA device and skip
inside the test where there is none."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
