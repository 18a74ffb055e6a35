
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Immutable configuration objects with ``with_*`` builders.

Rebuild of the ``ifs_physics_common.framework.config`` surface
(``PythonConfig`` / ``GT4PyConfig`` / ``IOConfig`` / ``DataTypes``,
SURVEY.md §2.2; usage ``drivers/config.py:22-48``,
``drivers/run_nonlinear.py:112, 210-218``) as frozen dataclasses.  The
GT4Py backend string is replaced by a JAX platform + precision pair — the
XLA analogue of selecting a backend — and the compile-time ``exec_info``
timing dict by the :class:`~cloudsc2_tpu.utils.timing.Timer` accumulator.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

#: the checkout's root: the default compile cache sits here whatever the
#: working directory (``.gitignore`` lists ``.jax_cache/``)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """The persistent compilation cache: ``JAX_COMPILATION_CACHE_DIR`` when
    set, otherwise ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.
    Where ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and
    nothing is set here."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return compile_cache_dir()


@dataclass(frozen=True)
class DataTypes:
    """Precision-resolved dtypes (reference ``DataTypes`` in drivers/config.py:41-44)."""

    bool: Any = np.bool_
    float: Any = np.float64
    int: Any = np.int64


@dataclass(frozen=True)
class JaxConfig:
    """Execution backend configuration (the GT4PyConfig analogue).

    ``platform``: "gpu" | "cpu" | None (None = environment default).
    ``rebuild`` skips the persistent XLA compilation cache (the analogue
    of the reference's ``.gt_cache`` compiled-stencil cache, ``rebuild``
    in ``drivers/config.py:45``; see :func:`compile_cache_dir`);
    ``validate_args`` enables shape/name checks in the component layer.
    """

    platform: Optional[str] = None
    rebuild: bool = False
    validate_args: bool = False
    verbose: bool = True
    dtypes: DataTypes = dataclasses.field(default_factory=DataTypes)

    def apply(self) -> None:
        """Apply platform / x64 / compile-cache settings to the live JAX
        process.  A platform must be chosen before JAX first initializes
        its backends; asking for one JAX cannot start raises."""
        import jax

        if self.platform is not None:
            jax.config.update("jax_platforms", self.platform)
            got = jax.devices()[0].platform
            if got != self.platform:
                raise RuntimeError(
                    f"asked for platform {self.platform!r}, but JAX runs on {got!r}"
                )
        if self.dtypes.float == np.float64:
            jax.config.update("jax_enable_x64", True)
        if not self.rebuild:
            enable_compile_cache()


@dataclass(frozen=True)
class IOConfig:
    """Driver I/O configuration (reference ``IOConfig``)."""

    output_csv_file: Optional[str] = None
    output_csv_file_stencils: Optional[str] = None
    host_name: str = "localhost"

    def with_output_csv_file(self, f: Optional[str]) -> "IOConfig":
        return dataclasses.replace(self, output_csv_file=f)

    def with_output_csv_file_stencils(self, f: Optional[str]) -> "IOConfig":
        return dataclasses.replace(self, output_csv_file_stencils=f)

    def with_host_name(self, h: str) -> "IOConfig":
        return dataclasses.replace(self, host_name=h)


@dataclass(frozen=True)
class Config:
    """Driver configuration (reference ``drivers/config.py:25-48``)."""

    precision: str = "double"  # "double" | "single"
    num_cols: int = 100
    num_runs: int = 1
    num_threads: int = 1
    enable_checks: bool = False
    enable_validation: bool = True
    input_file: Optional[str] = None
    reference_file: Optional[str] = None
    jax_config: JaxConfig = dataclasses.field(default_factory=JaxConfig)
    sharded: bool = False
    #: initialize jax.distributed (multi-host); implies ``sharded``
    distributed: bool = False

    @property
    def dtype(self) -> Any:
        return np.float64 if self.precision == "double" else np.float32

    def with_precision(self, p: str) -> "Config":
        if p not in ("double", "single"):
            raise ValueError(f"precision must be double|single, got {p!r}")
        dt = DataTypes(float=np.float64 if p == "double" else np.float32)
        return dataclasses.replace(
            self, precision=p, jax_config=dataclasses.replace(self.jax_config, dtypes=dt)
        )

    def with_backend(self, platform: Optional[str]) -> "Config":
        return dataclasses.replace(
            self, jax_config=dataclasses.replace(self.jax_config, platform=platform)
        )

    def with_checks(self, enabled: bool) -> "Config":
        return dataclasses.replace(
            self,
            enable_checks=enabled,
            jax_config=dataclasses.replace(self.jax_config, validate_args=enabled),
        )

    def with_validation(self, enabled: bool) -> "Config":
        return dataclasses.replace(self, enable_validation=enabled)

    def with_num_cols(self, n: int) -> "Config":
        return dataclasses.replace(self, num_cols=n)

    def with_num_runs(self, n: int) -> "Config":
        return dataclasses.replace(self, num_runs=n)

    def with_input_file(self, f: Optional[str]) -> "Config":
        return dataclasses.replace(self, input_file=f)

    def with_reference_file(self, f: Optional[str]) -> "Config":
        return dataclasses.replace(self, reference_file=f)

    def with_sharded(self, s: bool) -> "Config":
        return dataclasses.replace(self, sharded=s)

    def with_distributed(self, d: bool) -> "Config":
        return dataclasses.replace(self, distributed=d, sharded=self.sharded or d)


DEFAULT_CONFIG = Config()
DEFAULT_IO_CONFIG = IOConfig()
