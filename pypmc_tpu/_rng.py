"""Random-number-generator adapters.

The device code path uses explicit ``jax.random`` keys (functional,
splittable, reproducible across shardings).  For API parity with the
reference -- whose samplers accept numpy ``mtrand``-style objects
(``density/gauss.pyx:62-64``) -- host-side wrappers also accept numpy RNGs
or integer seeds.  These helpers normalize whatever the user passed.
"""

import numbers as _numbers

import numpy as _np

__all__ = ["is_jax_key", "as_jax_key", "RNG_DEFAULT"]

RNG_DEFAULT = _np.random.mtrand  # reference default rng

# module-level default key stream for rng=None: advancing it on every use
# makes repeated convenience calls (density.propose(N) in a loop) draw
# FRESH samples -- a fixed PRNGKey(0) silently returned identical batches
_default_key = None


def _next_default_key():
    global _default_key
    import jax

    if _default_key is None:
        _default_key = jax.random.PRNGKey(0)
    _default_key, sub = jax.random.split(_default_key)
    return sub


def is_jax_key(rng) -> bool:
    """True if ``rng`` is a ``jax.random`` PRNG key (new- or old-style)."""
    try:
        import jax
        import jax.numpy as jnp
    except ImportError:  # pragma: no cover
        return False
    if not isinstance(rng, jax.Array):
        return False
    if jnp.issubdtype(rng.dtype, jax.dtypes.prng_key):
        return True
    return rng.dtype == jnp.uint32 and rng.shape == (2,)


def as_jax_key(rng):
    """Convert ``rng`` (None | int | jax key) to a jax PRNG key, or return
    None if ``rng`` is a numpy-style generator."""
    import jax

    if rng is None:
        return _next_default_key()
    if isinstance(rng, _numbers.Integral):
        # incl. numpy integer scalars (np.int64 from an array of seeds
        # previously fell through to the 'numpy generator' branch and
        # crashed with AttributeError deep inside propose)
        return jax.random.PRNGKey(int(rng))
    if is_jax_key(rng):
        return rng
    return None
