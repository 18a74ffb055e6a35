
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Wall-clock timing utilities.

Rebuild of ``ifs_physics_common.framework.components`` timing surface used by
the reference drivers (``drivers/run_nonlinear.py:116-119``,
``run_taylor_test.py:96-99``; behavioral contract in SURVEY.md §2.2): a
``timing(label)`` context manager accumulating into a process-wide
:class:`Timer`, with ``Timer.reset()`` and ``Timer.get_time(label, units)``.

On accelerators, callers are responsible for synchronizing before exiting a
``timing`` block (:func:`device_sync`): JAX dispatch is asynchronous.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator

_UNITS = {"s": 1.0, "ms": 1e3, "us": 1e6}


def device_sync(tree):
    """Wait for a computation (``jax.block_until_ready``) before exiting a
    ``timing`` block.  Returns ``tree`` unchanged."""
    import jax

    return jax.block_until_ready(tree)


class Timer:
    """Process-wide accumulating timer keyed by label."""

    _times: Dict[str, float] = {}
    _counts: Dict[str, int] = {}

    @classmethod
    def reset(cls) -> None:
        cls._times = {}
        cls._counts = {}

    @classmethod
    def add(cls, label: str, seconds: float) -> None:
        cls._times[label] = cls._times.get(label, 0.0) + seconds
        cls._counts[label] = cls._counts.get(label, 0) + 1

    @classmethod
    def get_time(cls, label: str, units: str = "ms") -> float:
        return cls._times.get(label, 0.0) * _UNITS[units]

    @classmethod
    def get_count(cls, label: str) -> int:
        return cls._counts.get(label, 0)

    @classmethod
    def labels(cls):
        return tuple(cls._times)


@contextmanager
def timing(label: str) -> Iterator[None]:
    """Accumulate the wall time of the block under ``label``."""
    start = time.perf_counter()
    try:
        yield
    finally:
        Timer.add(label, time.perf_counter() - start)
