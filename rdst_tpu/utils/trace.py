"""Observability: algorithm-pick tracing and profiler helpers.

Reference equivalents: the ``work_profiles`` cargo feature printing
per-level picks (Cargo.toml:18, sorter.rs:78-79) and the
scripts/profiling.rs marker binary. Here the profiling story is
jax.profiler traces; ``profile_to`` wraps a region so device kernels show
up in TensorBoard/XProf.
"""
from __future__ import annotations

import contextlib

import jax

from rdst_tpu.config import work_profiles, work_profiles_enabled

__all__ = ["work_profiles", "work_profiles_enabled", "profile_to"]


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a jax.profiler trace of the enclosed region."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
