"""Exact chi-square samplers for wide vectors.

``jax.random.chisquare``/``gamma`` run the Marsaglia-Tsang rejection loop as
a masked whole-array ``while_loop``: iterations continue until EVERY element
has accepted, so the full N-sized array pays ~10+ rounds of normals,
uniforms and transcendentals for a tail of a few stragglers.

:func:`chi2_log` restructures the same EXACT algorithm for wide vectors:

1. three fixed Marsaglia-Tsang rounds over the full array (accept rate is
   >=95% per round, so all but a <=1.25e-4 fraction finish here);
2. the surviving rejects are COMPACTED into a tiny fixed-size buffer
   (capacity ~N/512, 16x the worst-case mean; overflow probability
   astronomically small by Chernoff) and only that buffer runs the
   unbounded rejection loop;
3. results scatter back.

The boost for shape < 1 (``Gamma(a) = Gamma(a+1) * U^(1/a)``) is applied
unconditionally and IN LOG SPACE, so tiny degrees of freedom (``mindof ~
1e-5`` in the PMC dof solver) neither under- nor overflow; callers that need
``sqrt(dof/chi2)`` (the Student-t proposal scale) stay in log space
throughout.

.. note::
    The proposal path uses the stock ``jax.random.chisquare``; whether this
    sampler is faster on the GPU is not measured.  It remains useful for
    tiny-dof log-space stability and as the reference implementation for
    the distributional tests.
"""

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["chi2_log", "chisquare", "student_t_scale"]


def _mt_round(key, d, c, shape, dtype):
    """One Marsaglia-Tsang proposal round for Gamma(d + 1/3).

    Returns ``(accepted mask, log of the gamma draw)``.
    """
    kz, ku = jax.random.split(key)
    z = jax.random.normal(kz, shape, dtype=dtype)
    u = jax.random.uniform(ku, shape, dtype=dtype, minval=jnp.finfo(dtype).tiny)
    one_plus_cz = 1.0 + c * z
    ok_v = one_plus_cz > 0
    safe = jnp.where(ok_v, one_plus_cz, 1.0)
    log_v = 3.0 * jnp.log(safe)
    # margin d*(1 - v + log v) written as d*(log_v - w) with w = v - 1 =
    # expm1(log_v): both terms are computed in high RELATIVE precision, so
    # the subtraction is benign -- the naive d - d*v + d*log_v cancels
    # catastrophically for large d (absolute rounding ~d*eps vs an O(1)
    # acceptance margin; visible from dof ~ 1e5 in float32)
    w = jnp.expm1(log_v)
    accept = ok_v & (jnp.log(u) < 0.5 * z * z + d * (log_v - w))
    log_g = jnp.log(d) + log_v
    return accept, log_g


@partial(jax.jit, static_argnames=("shape",))
def chi2_log(key, df, shape):
    """``log`` of exact chi-square draws with (per-element) degrees of
    freedom ``df`` (broadcast to ``shape``)."""
    dtype = jnp.asarray(df).dtype
    if not jnp.issubdtype(dtype, jnp.floating):
        dtype = jnp.zeros(0).dtype
    df = jnp.broadcast_to(jnp.asarray(df, dtype=dtype), shape)
    a = 0.5 * df
    # boost: sample Gamma(a + 1), multiply by U^(1/a) in log space
    d = a + 1.0 - 1.0 / 3.0
    c = 1.0 / jnp.sqrt(9.0 * d)

    k1, k2, k3, k4, ku = jax.random.split(key, 5)

    # three fixed rounds over the full array (accept >= 95% per round)
    acc1, logg1 = _mt_round(k1, d, c, shape, dtype)
    acc2, logg2 = _mt_round(k2, d, c, shape, dtype)
    acc3, logg3 = _mt_round(k4, d, c, shape, dtype)
    log_g = jnp.where(acc1, logg1, jnp.where(acc2, logg2, logg3))
    done = acc1 | acc2 | acc3

    # compact the stragglers (expected fraction <= 1.25e-4, worst-case
    # accept 0.95/round) and loop only them; capacity 16x the worst-case
    # mean keeps the scatter tiny while overflow stays astronomically
    # unlikely
    n = 1
    for s in shape:
        n *= int(s)
    cap = max(256, n // 512)
    flat_done = done.reshape(-1)
    (idx,) = jnp.nonzero(~flat_done, size=cap, fill_value=n)
    valid = idx < n
    safe_idx = jnp.where(valid, idx, 0)
    d_t = d.reshape(-1)[safe_idx]
    c_t = c.reshape(-1)[safe_idx]

    def cond(state):
        key, done_t, _ = state
        return ~jnp.all(done_t)

    def body(state):
        key, done_t, logg_t = state
        key, sub = jax.random.split(key)
        acc, logg = _mt_round(sub, d_t, c_t, (cap,), dtype)
        newly = acc & ~done_t
        return key, done_t | acc, jnp.where(newly, logg, logg_t)

    # zeros_like(d_t) (not a fresh zeros): under shard_map the carry must
    # inherit the "varying over the particle axis" tracking of the data
    _, _, logg_tail = jax.lax.while_loop(
        cond, body, (k3, ~valid, jnp.zeros_like(d_t))
    )

    log_g = log_g.reshape(-1).at[jnp.where(valid, idx, n)].set(
        logg_tail, mode="drop"
    ).reshape(shape)

    # chi2 = 2 * g * u^(1/a), on the log scale
    u = jax.random.uniform(ku, shape, dtype=dtype, minval=jnp.finfo(dtype).tiny)
    return jnp.log(2.0) + log_g + jnp.log(u) / a


def chisquare(key, df, shape):
    """Exact chi-square draws (linear scale); see :func:`chi2_log`."""
    return jnp.exp(chi2_log(key, df, shape))


def student_t_scale(key, dof, shape):
    """Per-particle Student-t proposal scale ``sqrt(dof / chi2(dof))``
    computed fully in log space (stable for dof down to ~1e-5)."""
    log_chi2 = chi2_log(key, dof, shape)
    dof = jnp.broadcast_to(jnp.asarray(dof, dtype=jnp.asarray(log_chi2).dtype), shape)
    return jnp.exp(0.5 * (jnp.log(dof) - log_chi2))
