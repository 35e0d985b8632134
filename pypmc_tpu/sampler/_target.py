"""Target-density adapters.

A target is a callable ``x (D,) -> log P(x)``.  Evaluating a per-sample
callable with ``vmap`` lowers quadratic forms to matmuls with tiny (D, D)
matrices against the huge particle axis.  Marking a target as *batched* -- a
callable over the whole sample block -- lets the samplers call it directly so
the author can use layouts/kernels that scale.

Internally the samplers carry particles TRANSPOSED ``(D, N)``
(structure-of-arrays: the particle axis last); a batched target may declare
``transposed=True`` to receive that layout directly and avoid any conversion
(e.g. ``MixtureDensity.evaluate_fn(batched=True)``).
"""

import jax
import jax.numpy as jnp

__all__ = ["batched_target", "is_batched", "is_transposed",
           "evaluate_target", "evaluate_target_T"]


def batched_target(fn=None, *, transposed=False):
    """Mark ``fn`` as a batched log-target.

    With ``transposed=False`` (default) it receives row-major ``(N, D)``
    blocks; with ``transposed=True`` it receives the samplers' device layout
    ``(D, N)``.  Either way it returns ``(N,)`` log-densities.  Usable as a
    plain decorator or with arguments.
    """

    def mark(f):
        f.__pypmc_tpu_batched__ = True
        f.__pypmc_tpu_transposed__ = transposed
        return f

    if fn is None:
        return mark
    return mark(fn)


def is_batched(fn) -> bool:
    return getattr(fn, "__pypmc_tpu_batched__", False)


def is_transposed(fn) -> bool:
    return getattr(fn, "__pypmc_tpu_transposed__", False)


def evaluate_target(target, samples):
    """Evaluate ``target`` on a row-major ``(N, D)`` sample block."""
    if is_batched(target):
        if is_transposed(target):
            return target(jnp.asarray(samples).T)
        return target(samples)
    return jax.vmap(target)(samples)


def evaluate_target_T(target, samples_T):
    """Evaluate ``target`` on a transposed ``(D, N)`` sample block (the
    samplers' device layout); only transposed-batched targets avoid the
    layout conversion."""
    if is_batched(target) and is_transposed(target):
        return target(samples_T)
    samples = jnp.asarray(samples_T).T
    if is_batched(target):
        return target(samples)
    return jax.vmap(target)(samples)
