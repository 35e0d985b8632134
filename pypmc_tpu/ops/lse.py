"""Weighted log-sum-exp and regularization kernels.

Batched replacement for the reference's Cython module
``pypmc/tools/_regularize.pyx``: the scalar max-shifted loops become fused
vector ops over the full ``(N, K)`` component-log-density matrix, which XLA
evaluates in one pass over device memory.
"""

import jax.numpy as jnp

__all__ = ["regularize", "logsumexp", "logsumexp2D", "tiny"]


def tiny(dtype) -> float:
    """Smallest positive normal float of ``dtype`` (reference: ``_np.finfo('d').tiny``)."""
    return float(jnp.finfo(dtype).tiny)


def regularize(x):
    """Replace exact zeros by the smallest positive float.

    Functional counterpart of ``regularize`` (``tools/_regularize.pyx:6-17``);
    does NOT mutate its input.
    """
    return jnp.where(x == 0, jnp.asarray(tiny(x.dtype), dtype=x.dtype), x)


def logsumexp(a, weights, axis=-1):
    r"""Weighted log-sum-exp :math:`\log \sum_i w_i e^{a_i}` over ``axis``.

    Max-shifted for stability exactly as the reference
    (``tools/_regularize.pyx:19-55``).  Entries with ``a = -inf`` contribute
    zero; if *all* entries along ``axis`` are ``-inf`` the result is ``-inf``
    (the reference's max-shift would produce NaN there, but that situation
    cannot occur for a normalized mixture with at least one live component).
    """
    a = jnp.asarray(a)
    max_val = jnp.max(a, axis=axis, keepdims=True)
    safe_max = jnp.where(jnp.isfinite(max_val), max_val, jnp.zeros_like(max_val))
    s = jnp.sum(weights * jnp.exp(a - safe_max), axis=axis)
    return jnp.log(s) + jnp.squeeze(safe_max, axis=axis)


def logsumexp2D(a, weights):
    """Row-wise weighted log-sum-exp of an ``(N, K)`` matrix.

    Counterpart of ``logsumexp2D`` (``tools/_regularize.pyx:57-83``).
    """
    return logsumexp(a, weights, axis=-1)
