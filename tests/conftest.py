"""Shared pytest config: the ``slow`` marker and the fast tier-1 selection.

Tier-1 (``PYTHONPATH=src python -m pytest -x -q``) must finish in minutes on
CPU, so tests marked ``@pytest.mark.slow`` are deselected by default; run
them with ``--runslow`` (or ``RUN_SLOW=1``) in scheduled/full CI.  This file
also puts tests/ on sys.path so the hypothesis fallback shim resolves.
"""
from __future__ import annotations

import os
import pathlib
import sys

import pytest

_HERE = str(pathlib.Path(__file__).resolve().parent)
if _HERE not in sys.path:  # robust under --import-mode=importlib too
    sys.path.insert(0, _HERE)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test, deselected by default "
        "(enable with --runslow or RUN_SLOW=1)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA GPU and nvcc; skips without one",
    )


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow: pass --runslow (or RUN_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
