"""Profiling helpers (a capability the reference lacks entirely --
SURVEY.md section 5: pypmc's only trace of profiling is a doc remark).

Thin wrappers over ``jax.profiler`` so sampler runs can be traced and viewed
in TensorBoard/XProf or summarized from Python.
"""

import contextlib
import time

import jax

__all__ = ["trace", "timed"]


@contextlib.contextmanager
def trace(logdir="/tmp/pypmc_tpu_trace"):
    """Context manager capturing an XLA device profiler trace to ``logdir``
    (view with TensorBoard's profile plugin / xprof)."""
    with jax.profiler.trace(logdir):
        yield logdir


@contextlib.contextmanager
def timed(label="block", results=None):
    """Wall-clock a block, waiting for all pending device work at entry and
    exit so asynchronous dispatch does not skew the number.  Appends
    ``(label, seconds)`` to ``results`` if given."""
    jax.effects_barrier()
    t0 = time.perf_counter()
    yield
    jax.effects_barrier()
    dt = time.perf_counter() - t0
    if results is not None:
        results.append((label, dt))
