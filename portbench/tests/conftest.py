"""The benchmark's own tests (``python -m pytest portbench/tests``): the
checkout's root on the path, and the repository's ``cuda`` marker, whose
tests skip without a card (each decides inside the test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
