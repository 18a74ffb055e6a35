
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Default driver configuration (reference ``drivers/config.py:25-48``)."""
from __future__ import annotations

import os

from cloudsc2_tpu.config import Config, IOConfig

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data")


def default_input_file() -> str | None:
    """The synthetic input file (upstream ``data/input.h5`` schema, stored
    as ``.npz``), if it exists — drivers load it and tile columns to ``--num-cols`` like the
    reference does, so golden validation works at any column count; callers
    fall back to in-memory synthesis when it is absent."""
    path = os.path.normpath(os.path.join(_DATA_DIR, "input_synth.npz"))
    return path if os.path.exists(path) else None


def default_reference_file(precision: str) -> str:
    """Golden-output file for the synthetic workload, per precision
    (the analogue of ``data/reference_{double,single}.h5``,
    reference ``drivers/config.py:28-34``)."""
    return os.path.normpath(
        os.path.join(_DATA_DIR, f"reference_synth_{precision}.npz")
    )


DEFAULT_CONFIG = Config(
    precision="double",
    num_cols=100,
    num_runs=1,
    enable_checks=False,
    enable_validation=True,
)
DEFAULT_IO_CONFIG = IOConfig()
