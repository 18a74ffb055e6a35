# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Hand-written GPU kernels for the CLOUDSC2 schemes (Pallas, Triton
route): one level-scan kernel (:mod:`cloudsc2_tpu.pallas.levelscan`) whose
per-level bodies are the physics functions the ``lax.scan`` paths run.
"""
