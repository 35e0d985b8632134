"""Functional density core: stacked-parameter mixtures as pytrees.

This is the array-programming redesign of the reference's density layer
(``pypmc/density/gauss.pyx``, ``student_t.pyx``, ``mixture.pyx``): instead of
a Python list of component objects each with its own scalar-loop ``evaluate``,
a mixture is ONE pytree of stacked arrays

    means (K, D), chol/inv_chol/inv_sigma (K, D, D), log_det (K,),
    weights (K,), [dof (K,) for Student-t]

and every operation is a single batched computation:

* :func:`component_logpdfs` produces the full ``(N, K)`` log-density matrix
  (the reference computes it with per-component Cython N-loops,
  ``mixture.pyx:112-156``) through one big ``(N,D) x (K,D,D)`` contraction.
* :func:`mixture_logpdf_T` fuses the weighted log-sum-exp on top
  (``mixture.pyx:101-110`` + ``_regularize.pyx:57``); on the GPU, large
  float32 batches go through one fused kernel
  (:mod:`pypmc_tpu.ops.mixture_kernel`) that never writes the ``(N, K, D)``
  projection.
* :func:`propose` replaces multinomial block-allocation + shuffle
  (``mixture.pyx:159-212``) with an order-free per-particle categorical draw
  + gather -- same distribution, shard-friendly along the particle axis.

Component death is represented by ``weights == 0`` with the old (still valid)
parameters kept in place -- mirroring the reference's live-component lists
(``mix_adapt/pmc.pyx:85-117``) while keeping all shapes static for XLA.
"""

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.linalg import chol_inv_det, symmetrize
from ..ops import mixture_kernel
from ..ops.lse import logsumexp


def _kernel_operands(params: "MixtureParams"):
    """Operands of the fused GPU kernel (:mod:`pypmc_tpu.ops.mixture_kernel`):
    ``center (D,)``, ``u (K, D, D)``, ``b (K, D)``, ``coef (K, 3)``.

    ``center`` is the mixture's weighted mean; the kernel subtracts it from
    the particles before anything else, so float32 accuracy depends on the
    spread of the particles around the mixture, not on their distance from
    the origin."""
    w = params.weights
    center = jnp.einsum("k,kd->d", w, params.means, precision="highest")
    u = params.inv_chol
    b = jnp.einsum("kij,kj->ki", u, params.means - center[None, :],
                   precision="highest")
    lw = jnp.where(w > 0, jnp.log(jnp.where(w > 0, w, 1.0))
                   + log_normalization(params), -jnp.inf)
    if params.is_student_t:
        coef = jnp.stack([lw, 0.5 * (params.dof + params.dim), 1.0 / params.dof],
                         axis=-1)
    else:
        coef = jnp.stack([lw, jnp.zeros_like(lw), jnp.zeros_like(lw)], axis=-1)
    return center, u, b, coef


__all__ = [
    "MixtureParams",
    "make_mixture",
    "gauss_log_norm",
    "student_t_log_norm",
    "log_normalization",
    "mahalanobis",
    "mahalanobis_all",
    "mahalanobis_all_T",
    "component_logpdfs",
    "mixture_logpdf",
    "mixture_logpdf_T",
    "propose",
    "propose_T",
    "propose_logq_T",
    "update_masked",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MixtureParams:
    """Stacked parameters of a Gaussian or Student-t mixture.

    ``dof is None`` selects the Gaussian family; a ``(K,)`` array of degrees
    of freedom selects Student-t.  ``weights`` are normalized; a weight of
    exactly 0 marks a dead component (kept with its last valid parameters).
    """

    means: jax.Array       # (K, D)
    cov: jax.Array         # (K, D, D)
    chol: jax.Array        # (K, D, D) lower Cholesky of cov
    inv_chol: jax.Array    # (K, D, D) U = L^{-1}
    inv_sigma: jax.Array   # (K, D, D)
    log_det: jax.Array     # (K,)
    weights: jax.Array     # (K,)
    dof: Optional[jax.Array] = None  # (K,) or None

    @property
    def K(self) -> int:
        return self.means.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    @property
    def is_student_t(self) -> bool:
        return self.dof is not None


def make_mixture(means, covs, weights=None, dofs=None):
    """Build :class:`MixtureParams` from raw means/covariances(/dofs).

    Returns ``(params, valid)`` where ``valid`` is a ``(K,)`` bool mask that
    is False for components whose covariance is not symmetric
    positive-definite (counterpart of the reference's ``LinAlgError``,
    see :mod:`pypmc_tpu.ops.linalg`).  Weights are normalized.
    """
    means = jnp.asarray(means)
    covs = jnp.asarray(covs)
    K = means.shape[0]
    if weights is None:
        weights = jnp.ones((K,), dtype=means.dtype)
    weights = jnp.asarray(weights, dtype=means.dtype)
    weights = weights / jnp.sum(weights)
    res = chol_inv_det(covs)
    dof = None if dofs is None else jnp.asarray(dofs, dtype=means.dtype)
    params = MixtureParams(
        means=means,
        cov=covs,
        chol=res.chol,
        inv_chol=res.inv_chol,
        inv_sigma=res.inv,
        log_det=res.log_det,
        weights=weights,
        dof=dof,
    )
    return params, res.valid


def gauss_log_norm(log_det, dim):
    """Gaussian log-normalization (``density/gauss.pyx:54-56``)."""
    return -0.5 * dim * jnp.log(2 * jnp.pi) - 0.5 * log_det


def student_t_log_norm(log_det, dof, dim):
    """Student-t log-normalization (``density/student_t.pyx:32-34``)."""
    return (
        jax.scipy.special.gammaln(0.5 * (dof + dim))
        - jax.scipy.special.gammaln(0.5 * dof)
        - 0.5 * dim * jnp.log(dof * jnp.pi)
        - 0.5 * log_det
    )


def log_normalization(params: MixtureParams) -> jax.Array:
    """Per-component log-normalization constants, shape ``(K,)``."""
    if params.is_student_t:
        return student_t_log_norm(params.log_det, params.dof, params.dim)
    return gauss_log_norm(params.log_det, params.dim)


def mahalanobis(x, means, inv_chol):
    """Squared Mahalanobis distances ``(N, K)`` of points to all components.

    Computed as ``|| U_k x_n - U_k mu_k ||^2`` with ``U = L^{-1}`` so the
    dominant cost is ONE ``(N,D) x (D, K*D)`` matmul rather than K separate
    quadratic forms (the reference's ``bilinear_sym`` N-loops).
    """
    # proj[n,k,i] = sum_d U[k,i,d] * x[n,d]
    # precision="highest": a reduced-precision (TF32 or bfloat16) product
    # costs ~3 decimal digits in the distances
    proj = jnp.einsum("nd,kid->nki", x, inv_chol, precision="highest")
    b = jnp.einsum("kd,kid->ki", means, inv_chol, precision="highest")
    diff = proj - b[None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def mahalanobis_all_T(params: MixtureParams, xT) -> jax.Array:
    """``(K, N)`` squared Mahalanobis distances for transposed particles
    ``xT (D, N)``."""
    xT = jnp.asarray(xT)
    return mahalanobis(xT.T, params.means, params.inv_chol).T


def mahalanobis_all(params: MixtureParams, x) -> jax.Array:
    """``(N, K)`` squared Mahalanobis distances of row-major ``x (N, D)``."""
    return mahalanobis_all_T(params, jnp.asarray(x).T).T


def component_logpdfs(params: MixtureParams, x) -> jax.Array:
    """Per-component log-densities, shape ``(N, K)``.

    Batched equivalent of ``MixtureDensity.multi_evaluate(..., individual=...)``
    (``density/mixture.pyx:112-156``).
    """
    x = jnp.asarray(x)
    maha = mahalanobis(x, params.means, params.inv_chol)
    log_norm = log_normalization(params)
    if params.is_student_t:
        return log_norm[None, :] - 0.5 * (params.dof + params.dim)[None, :] * jnp.log1p(
            maha / params.dof[None, :]
        )
    return log_norm[None, :] - 0.5 * maha


def mixture_logpdf_T(params: MixtureParams, xT) -> jax.Array:
    """Mixture log-density ``log q(x_n)``, shape ``(N,)``, for TRANSPOSED
    particles ``xT (D, N)`` (the particle axis last, the layout the samplers
    keep on the device).

    The per-component log-densities and the weighted log-sum-exp
    (``mixture.pyx:101-110``) run as one fused kernel where
    :func:`pypmc_tpu.ops.mixture_kernel.use_kernel` says so (GPU, float32,
    large batches), as XLA operations otherwise.
    """
    xT = jnp.asarray(xT)
    if mixture_kernel.use_kernel(xT):
        return mixture_kernel.mixture_logq(
            xT, *_kernel_operands(params), student_t=params.is_student_t)
    return logsumexp(component_logpdfs(params, xT.T), params.weights, axis=-1)


def mixture_logpdf(params: MixtureParams, x) -> jax.Array:
    """Mixture log-density for row-major ``x (N, D)`` (host-facing API;
    jitted pipelines should prefer :func:`mixture_logpdf_T`)."""
    return mixture_logpdf_T(params, jnp.asarray(x).T)


def _cumulative_weights(weights):
    """Inverse-CDF thresholds computed from the TAIL sums,
    ``cumw[k] = 1 - sum_{j>k} w_j``: for a DEAD component k (weight 0) the
    two thresholds bounding its interval are the *same* partial sum, so
    the interval is empty bit-exactly, and the last threshold is exactly
    1 -- a forward ``cumsum`` instead can round the total below 1 in
    float32, handing ``u`` in [total, 1) to a dead trailing component
    (~1-10 draws per 1e7-particle step)."""
    tail = jnp.cumsum(weights[::-1])[::-1]          # sum_{j>=k} w_j
    tail_excl = jnp.concatenate([tail[1:], jnp.zeros((1,), weights.dtype)])
    return 1.0 - tail_excl


@partial(jax.jit, static_argnames=("n",))
def propose_T(params: MixtureParams, key, n: int):
    """Draw ``n`` samples from the mixture in the TRANSPOSED layout; return
    ``(samples_T (D, n), latent (n,))``.

    Per-particle categorical component choice + affine transform of standard
    normals (Student-t additionally scales by ``sqrt(dof / chi2(dof))``,
    ``student_t.pyx:49-55``).  Unlike the reference's multinomial block
    allocation (``mixture.pyx:159-212``) the output needs no shuffle and
    shards trivially along the particle axis.
    """
    k_cat, k_norm, k_chi = jax.random.split(key, 3)
    dtype = params.means.dtype
    # inverse-CDF categorical draw: ONE uniform per particle and K-1 lane
    # compares, instead of Gumbel-argmax's N*K transcendentals; dead
    # components (weight 0) have an empty interval and are never drawn
    u = jax.random.uniform(k_cat, (n,), dtype=dtype)
    cumw = _cumulative_weights(params.weights)
    latent = jnp.sum(u[None, :] >= cumw[:-1, None], axis=0).astype(jnp.int32)
    zT = jax.random.normal(k_norm, (params.dim, n), dtype=dtype)

    if params.is_student_t:
        dof_n = params.dof[latent]
        chi2 = jax.random.chisquare(k_chi, dof_n, shape=(n,), dtype=dtype)
        # float32 chi2 underflows to exactly 0 with probability
        # ~tiny^(dof/2) (noticeable for dof < ~1): clamp so the scale
        # stays finite instead of proposing points at infinity
        chi2 = jnp.maximum(chi2, jnp.finfo(dtype).tiny)
        scale = jnp.sqrt(dof_n / chi2)
    else:
        scale = jnp.ones((n,), dtype=dtype)

    # gather (D, K) column panels of the Cholesky factors by latent and
    # accumulate over j, instead of gathering an (N, D, D) table: only ONE
    # gathered (D, N) panel is live at a time under lax.scan (an unrolled
    # loop kept all D panels live: 165 GB at K=64, D=40, N=2^23).
    chol_cols = params.chol.transpose(2, 1, 0)  # (j, D, K)

    def _acc_col(acc, col):
        Lj, zj = col
        return acc + Lj[:, latent] * zj[None, :], None

    acc, _ = jax.lax.scan(_acc_col, jnp.zeros_like(zT), (chol_cols, zT))
    samples_T = params.means.T[:, latent] + acc * scale[None, :]
    return samples_T, latent


@partial(jax.jit, static_argnames=("n",))
def propose(params: MixtureParams, key, n: int):
    """Row-major variant of :func:`propose_T`: returns
    ``(samples (n, D), latent (n,))``."""
    samples_T, latent = propose_T(params, key, n)
    return samples_T.T, latent


@partial(jax.jit, static_argnames=("n",))
def propose_logq_T(params: MixtureParams, key, n: int, target_params=None):
    """Propose and evaluate: draw ``n`` mixture samples and evaluate the
    proposal log-density (and optionally a second, target mixture's
    log-density) on them, in one jitted computation.

    Returns ``(samples_T (D, n), latent (n,), log_q (n,))``, plus
    ``log_p (n,)`` when ``target_params`` is given.  Composes
    :func:`propose_T` and :func:`mixture_logpdf_T`.
    """
    samples_T, latent = propose_T(params, key, n)
    log_q = mixture_logpdf_T(params, samples_T)
    if target_params is None:
        return samples_T, latent, log_q
    return samples_T, latent, log_q, mixture_logpdf_T(target_params, samples_T)


def update_masked(params: MixtureParams, new_means, new_covs, new_weights,
                  new_dofs=None, update_mask=None):
    """Batched masked parameter update with PSD-validity fallback.

    For every component where ``update_mask`` is True, attempt the update;
    where the new covariance is not symmetric positive-definite, keep ALL old
    parameters and set the component weight to zero, then renormalize --
    exactly the reference's ``LinAlgError -> weight 0`` protocol
    (``mix_adapt/pmc.pyx:227-245``), but branchless over K.

    Returns ``(new_params, ok_mask)`` where ``ok_mask`` marks components that
    were updated successfully.
    """
    K = params.K
    if update_mask is None:
        update_mask = jnp.ones((K,), dtype=bool)
    new_covs = symmetrize(jnp.asarray(new_covs))
    res = chol_inv_det(new_covs)
    ok = update_mask & res.valid
    sel_m = ok[:, None]
    sel_c = ok[:, None, None]
    # the caller decides every component's new weight (e.g. 0 for killed
    # ones); a failed update additionally forces weight 0 (component died)
    weights = jnp.asarray(new_weights)
    weights = jnp.where(update_mask & ~res.valid, 0.0, weights)
    # all-dead guard: if every component died, keep all weights at exactly
    # 0 (host callers check `weights > 0` and stop/fall back) instead of
    # the 0/0 -> all-NaN mixture a bare renormalization would produce
    total = jnp.sum(weights)
    weights = jnp.where(total > 0, weights / jnp.where(total > 0, total, 1.0),
                        0.0)
    dof = params.dof
    if dof is not None and new_dofs is not None:
        dof = jnp.where(ok, new_dofs, dof)
    return (
        MixtureParams(
            means=jnp.where(sel_m, new_means, params.means),
            cov=jnp.where(sel_c, new_covs, params.cov),
            chol=jnp.where(sel_c, res.chol, params.chol),
            inv_chol=jnp.where(sel_c, res.inv_chol, params.inv_chol),
            inv_sigma=jnp.where(sel_c, res.inv, params.inv_sigma),
            log_det=jnp.where(ok, res.log_det, params.log_det),
            weights=weights,
            dof=dof,
        ),
        ok,
    )
