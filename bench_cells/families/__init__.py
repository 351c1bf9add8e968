"""Encoder families, one module each: ``bench_cells/families/<family>.py``,
found by the ``family`` a configuration file names. ``bench_cells/harness.py``
says what such a module defines. A family module imports only ``torch``,
``numpy`` and ``bench_cells``, never the measured program."""

from __future__ import annotations

import importlib


def family(name: str):
    """The module of the encoder family ``name``."""
    return importlib.import_module(f"bench_cells.families.{name}")
