"""Batched linear-algebra kernels.

Batched replacement for the reference's Cython linalg layer
(``pypmc/tools/_linalg.pyx``): instead of scalar loops over a single
symmetric matrix, everything here operates on *stacked* parameter arrays
``(..., D, D)`` so that XLA can batch the work into few large kernels and fuse
surrounding element-wise math.

Failure semantics: the reference raises ``numpy.linalg.LinAlgError`` when a
covariance is not symmetric positive-definite (``_linalg.pyx:41-95``).  Under
``jit`` we cannot raise data-dependently, so :func:`chol_inv_det` instead
returns an explicit ``valid`` mask (NaN-free Cholesky succeeded) that callers
use to keep old parameters and zero the weight of dead components --
branchless and batched, exactly the fallback behaviour of the reference
(``mix_adapt/pmc.pyx:227-245``).
"""

import jax
import jax.numpy as jnp
from typing import NamedTuple

__all__ = ["bilinear_sym", "chol_inv_det", "CholResult", "symmetrize"]


class CholResult(NamedTuple):
    """Result of :func:`chol_inv_det` on a stack of symmetric matrices."""

    chol: jax.Array      #: (..., D, D) lower Cholesky factor L with M = L L^T
    inv_chol: jax.Array  #: (..., D, D) U = L^{-1} (lower triangular)
    inv: jax.Array       #: (..., D, D) M^{-1} = U^T U
    log_det: jax.Array   #: (...,) log det M
    valid: jax.Array     #: (...,) bool; True where M was symmetric PD


def symmetrize(m: jax.Array) -> jax.Array:
    """Return the symmetric part ``(M + M^T) / 2`` of ``(..., D, D)``."""
    return 0.5 * (m + jnp.swapaxes(m, -1, -2))


def bilinear_sym(matrix: jax.Array, vector: jax.Array) -> jax.Array:
    """Batched symmetric bilinear form ``x^T M x``.

    Replaces the reference's scalar triangular loop
    (``tools/_linalg.pyx:10-39``) with a fused einsum; broadcasts over
    leading batch dimensions of ``matrix`` ``(..., D, D)`` and ``vector``
    ``(..., D)``.
    """
    return jnp.einsum("...i,...ij,...j->...", vector, matrix, vector, precision="highest")


def chol_inv_det(m: jax.Array) -> CholResult:
    """Batched Cholesky + inverse + log-determinant with validity mask.

    Batched equivalent of ``chol_inv_det`` in the reference
    (``tools/_linalg.pyx:41-95``), vectorized over any leading batch
    dimensions of ``m`` with shape ``(..., D, D)``.

    ``jnp.linalg.cholesky`` produces NaNs (instead of raising) for
    non-positive-definite input; ``valid`` is False exactly there.  Only the
    lower triangle of ``m`` is read, so callers that construct ``m`` from
    sums of outer products should :func:`symmetrize` first if exact symmetry
    matters.
    """
    d = m.shape[-1]
    chol = jnp.linalg.cholesky(m)
    valid = jnp.all(jnp.isfinite(chol), axis=(-1, -2)) & jnp.all(
        jnp.isfinite(m), axis=(-1, -2)
    )
    # Avoid NaN propagation through triangular_solve for invalid members:
    # substitute the identity, results there are masked out by ``valid``.
    eye = jnp.eye(d, dtype=m.dtype)
    safe_chol = jnp.where(valid[..., None, None], chol, eye)
    inv_chol = jax.scipy.linalg.solve_triangular(
        safe_chol, jnp.broadcast_to(eye, safe_chol.shape), lower=True
    )
    inv = jnp.einsum("...ji,...jk->...ik", inv_chol, inv_chol, precision="highest")  # U^T U
    diag = jnp.diagonal(safe_chol, axis1=-2, axis2=-1)
    log_det = 2.0 * jnp.sum(jnp.log(diag), axis=-1)
    valid = valid & jnp.isfinite(log_det)
    return CholResult(chol=chol, inv_chol=inv_chol, inv=inv, log_det=log_det, valid=valid)
