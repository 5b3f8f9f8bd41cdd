"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of a checkout. Tests marked ``card`` need a CUDA card and skip
without one, deciding inside the test."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
