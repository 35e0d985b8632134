"""Population Monte Carlo (PMC) mixture updates on the accelerator.

Re-design of the reference's ``pypmc/mix_adapt/pmc.pyx``: the
Rao-Blackwellized responsibilities, the [Cap+08] eq. (14) sufficient
statistics, the Student-t gamma pass and the [HOD12] eq. (16)
degree-of-freedom update are ONE jitted computation over stacked mixture
parameters.  Component death ("LinAlgError -> weight 0", ``pmc.pyx:227-245``)
becomes a branchless validity mask; the ``brentq`` dof root-solve
(``pmc.pyx:683-710``) becomes a fixed-iteration bisection ``vmap``-ed over
components (the condition is monotone decreasing in nu).

All reductions over the particle axis are plain sums, so the same update
runs sharded over a device mesh with ``psum`` (see
:mod:`pypmc_tpu.parallel`).
"""

from copy import deepcopy as _cp
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as _np

from ..density import core as _core
from ..density.gauss import Gauss
from ..density.mixture import MixtureDensity
from ..density.student_t import StudentT
from ..ops import mixture_kernel
from ..ops.lse import logsumexp, regularize, tiny

import logging

logger = logging.getLogger(__name__)

__all__ = ["gaussian_pmc", "student_t_pmc", "PMC",
           "calculate_rho_rb", "calculate_rho_rb_T", "pmc_update", "PMCResult",
           "pmc_step_mixture_target"]


# --------------------------------------------------------------------- #
# functional core (jittable)                                            #
# --------------------------------------------------------------------- #

def calculate_rho_rb_T(params: _core.MixtureParams, samples_T) -> jax.Array:
    """Rao-Blackwellized responsibilities ``rho`` with shape ``(K, N)`` for
    TRANSPOSED particles ``samples_T (D, N)``.

    ``rho[k,n] = w_k q_k(x_n) / (q(x_n) + tiny)`` -- the reference's
    ``calculate_rho_rb`` (``pmc.pyx:23-43``) as one batched computation.
    Dead components (weight 0) get exactly zero.  Where
    :func:`pypmc_tpu.ops.mixture_kernel.use_kernel` says so (GPU, float32,
    large batches) this is one fused kernel pass over the particles.
    """
    samples_T = jnp.asarray(samples_T)
    if mixture_kernel.use_kernel(samples_T):
        rho, _ = mixture_kernel.mixture_rho(
            samples_T, *_core._kernel_operands(params),
            student_t=params.is_student_t)
        return rho
    logpdfs = _core.component_logpdfs(params, samples_T.T)  # (N, K)
    log_denom = logsumexp(logpdfs, params.weights, axis=-1)
    # LOG-SPACE ratio: the reference's linear form exp(l)*w/(exp(L)+tiny)
    # (pmc.pyx:37-41) underflows BOTH sides for any sample with mixture
    # log-density below the dtype's exp range (~-87 in float32 -- routine
    # at D >= 20), silently dropping it from the statistics; exp(l - L)*w
    # is the same quantity, exact in the ratio, and needs no tiny
    # (log_denom is finite whenever any component weight is positive)
    rho = jnp.exp(logpdfs - log_denom[:, None]) * params.weights[None, :]
    return jnp.where(params.weights[None, :] > 0, rho, 0.0).T


def calculate_rho_rb(params: _core.MixtureParams, samples) -> jax.Array:
    """Row-major variant of :func:`calculate_rho_rb_T`: ``rho (N, K)`` for
    ``samples (N, D)``."""
    return calculate_rho_rb_T(params, jnp.asarray(samples).T).T


def _rho_non_rb_T(params: _core.MixtureParams, latent, n_components: int) -> jax.Array:
    """One-hot responsibilities (K, N) from latent variables
    (``pmc.pyx:45-51``), zeroed for dead components."""
    ks = jnp.arange(n_components, dtype=latent.dtype)[:, None]
    onehot = (latent[None, :] == ks).astype(params.weights.dtype)
    return jnp.where(params.weights[:, None] > 0, onehot, 0.0)


def _cov_sums_T(samples_T, c_T, mu):
    """``(K, D, D)`` centered second-moment sums
    ``S_k = sum_n c_kn (x_n - mu_k)(x_n - mu_k)^T`` for transposed
    particles.

    Mapped sequentially over K so only a ``(D, N)`` intermediate exists per
    component; each step is a matmul ``(D, N) @ (N, D)`` with the huge
    particle axis as the contraction dimension.
    """
    def per_k(args):
        c_k, mu_k = args  # (N,), (D,)
        diff = samples_T - mu_k[:, None]
        return jnp.einsum("n,in,jn->ij", c_k, diff, diff, precision="highest")

    return jax.lax.map(per_k, (c_T, mu))


class PMCResult(NamedTuple):
    """Result of one :func:`pmc_update`; ``rho`` holds the ``(K, N)``
    responsibilities (transposed layout) of the pre-update parameters."""

    params: _core.MixtureParams
    rho: jax.Array            # (K, N) responsibilities (transposed layout)
    updated_ok: jax.Array     # (K,) bool; updated components that stayed valid
    live: jax.Array           # (K,) bool; live components before the update


@partial(jax.jit, static_argnames=("rb", "mincount", "dof_solver_steps",
                                   "axis_name", "transposed"))
def pmc_update(
    params: _core.MixtureParams,
    samples,
    weights=None,
    latent=None,
    rb: bool = True,
    mincount: int = 0,
    dof_solver_steps: int = 100,
    mindof: float = 1e-5,
    maxdof: float = 1e3,
    axis_name: Optional[str] = None,
    transposed: bool = False,
) -> PMCResult:
    """One (M-)PMC update of a Gaussian or Student-t mixture ([Cap+08] eq. 14,
    [HOD12] for the dof) as a single jitted computation.

    :param params: stacked mixture parameters (Gaussian iff ``params.dof`` is
        None).
    :param samples: ``(N, D)`` samples drawn from the current mixture, or
        ``(D, N)`` with ``transposed=True`` (the layout the samplers keep on
        the device; hot pipelines should pass it to avoid transposes).
    :param weights: ``(N,)`` unnormalized importance weights, or None for
        equal weights.
    :param latent: ``(N,)`` int indices of the generating components, or
        None (requires ``rb=True``).
    :param rb: Rao-Blackwellized responsibilities (True) or one-hot from
        ``latent`` (False).
    :param mincount: kill components that generated fewer than this many
        samples (requires ``latent``).
    :param dof_solver_steps: bisection iterations for the Student-t dof
        update; 0 disables the dof update.
    :param mindof, maxdof: search interval for the dof root-solve.
    :param axis_name: if given, ``samples``/``weights``/``latent`` are the
        LOCAL shard of a particle axis sharded under ``shard_map`` over a
        mesh axis with this name; all sufficient statistics are all-reduced
        with ``psum`` (O(K D^2) communication -- this replaces the
        reference's O(N D) MPI gather-to-rank-0,
        ``tools/parallel_sampler.py:58-71``).  Every shard computes the
        identical updated mixture.
    :param transposed: whether ``samples`` is ``(D, N)``.
    """
    samples_T = jnp.asarray(samples)
    if not transposed:
        samples_T = samples_T.T
    dim, N = samples_T.shape
    K = params.K
    dtype = samples_T.dtype

    def psum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    if weights is None:
        w = jnp.ones((N,), dtype=dtype)
        weight_normalization = psum(jnp.asarray(float(N), dtype=dtype))
    else:
        w = jnp.asarray(weights, dtype=dtype)
        weight_normalization = psum(jnp.sum(w))

    live = params.weights > 0

    # kill components with fewer than ``mincount`` samples (``pmc.pyx:109-116``)
    if latent is not None and mincount > 0:
        count = psum(jnp.bincount(latent, length=K))
        live = live & (count >= mincount)

    dof_stats = params.is_student_t and bool(dof_solver_steps)
    if rb:
        rho = calculate_rho_rb_T(params, samples_T)   # (K, N)
    else:
        rho = _rho_non_rb_T(params, latent, K)

    # ---- [Cap+08] eq. (14) sufficient statistics ------------------ #
    wrho = w[None, :] * rho                          # (K, N)
    alpha_unnorm = psum(jnp.sum(wrho, axis=1))       # (K,)
    inv_unnorm_alpha = 1.0 / regularize(alpha_unnorm)
    alpha = alpha_unnorm / weight_normalization

    if params.is_student_t:
        # gamma pass with the OLD parameters (``pmc.pyx:601-610``)
        maha_old = _core.mahalanobis_all_T(params, samples_T)   # (K, N)
        nu = params.dof[:, None]
        gamma = (nu + dim) / (nu + maha_old)         # (K, N)
        c_mu = wrho * gamma
        mu_norm = 1.0 / regularize(psum(jnp.sum(c_mu, axis=1)))
        mu = psum(jnp.einsum("kn,in->ki", c_mu, samples_T, precision="highest")) * mu_norm[:, None]
        cov = psum(_cov_sums_T(samples_T, c_mu, mu)) * inv_unnorm_alpha[:, None, None]
    else:
        mu = psum(jnp.einsum("kn,in->ki", wrho, samples_T, precision="highest")) * inv_unnorm_alpha[:, None]
        cov = psum(_cov_sums_T(samples_T, wrho, mu)) * inv_unnorm_alpha[:, None, None]

    const = None
    if dof_stats:
        nu_old = params.dof[:, None]
        b = maha_old  # bilinear form with old inverse sigma, (K, N)
        xi = rho * (jnp.log(0.5 * (b + nu_old))
                    - jax.scipy.special.digamma(0.5 * (dim + nu_old))) \
            + (1.0 - rho) * (jnp.log(0.5 * nu_old)
                             - jax.scipy.special.digamma(0.5 * nu_old))
        delta = rho * (dim + nu_old) / (b + nu_old) + (1.0 - rho)
        const = 1.0 - psum(jnp.einsum("kn,n->k", xi + delta, w,
                                      precision="highest")) / weight_normalization

    # ---- Student-t dof first-order condition, [HOD12] eq. (16) -------- #
    new_dofs = None
    if dof_stats:
        new_dofs = _solve_dofs(const, params.dof, dof_solver_steps,
                               mindof, maxdof, dtype)
    elif params.is_student_t:
        new_dofs = params.dof

    # ---- masked parameter update with PSD-validity fallback ----------- #
    new_weights = jnp.where(live, alpha, params.weights * 0.0)
    new_params, ok = _core.update_masked(
        params, mu, cov, new_weights, new_dofs=new_dofs, update_mask=live
    )
    return PMCResult(params=new_params, rho=rho, updated_ok=ok, live=live)


def _solve_dofs(const, old_dofs, dof_solver_steps, mindof, maxdof, dtype):
    """Per-component [HOD12] eq. (16) first-order condition solved by
    fixed-iteration bisection vmapped over K (the condition is monotone
    decreasing in nu); no-sign-change brackets clamp to the interval ends
    per monotonicity (``pmc.pyx:700-710``)."""
    def condition(nu, c):
        return c + jnp.log(0.5 * nu) - jax.scipy.special.digamma(0.5 * nu)

    def solve_one(c, old_dof):
        f_lo = condition(mindof, c)
        f_hi = condition(maxdof, c)

        def body(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            go_right = condition(mid, c) > 0  # decreasing: root right of mid
            return (jnp.where(go_right, mid, lo), jnp.where(go_right, hi, mid))

        lo, hi = jax.lax.fori_loop(
            0, dof_solver_steps, body,
            (jnp.asarray(mindof, dtype), jnp.asarray(maxdof, dtype)),
        )
        root = 0.5 * (lo + hi)
        root = jnp.where(f_lo < 0, mindof, root)
        root = jnp.where(f_hi > 0, maxdof, root)
        return jnp.where(jnp.isfinite(root), root, old_dof)

    return jax.vmap(solve_one)(const, old_dofs)


@partial(jax.jit, static_argnames=("n", "dof_solver_steps", "axis_name"))
def pmc_step_mixture_target(
    params: _core.MixtureParams,
    target_params: _core.MixtureParams,
    key,
    n: int,
    dof_solver_steps: int = 100,
    mindof: float = 1e-5,
    maxdof: float = 1e3,
    axis_name: Optional[str] = None,
):
    """One COMPLETE (M-)PMC training step against a MIXTURE target --
    propose, evaluate proposal and target, weight, Rao-Blackwellized
    responsibilities, gamma pass, and every sufficient statistic -- as one
    jitted computation: :func:`pypmc_tpu.density.core.propose_logq_T`
    followed by :func:`pmc_update`.

    Always Rao-Blackwellized (``rb=True``).  With ``axis_name``, ``n`` is
    the LOCAL particle count per shard and all statistics are psum-reduced.

    :returns: ``(result, samples_T (D, n), weights (n,), latent (n,),
        sw (3,))`` with ``result`` a :class:`PMCResult` and ``sw`` the
        GLOBAL ``[sum w, sum w^2, sum w log w]`` weight diagnostics.
    """
    def psum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    samples_T, latent, log_q, log_p = _core.propose_logq_T(
        params, key, n, target_params)
    w = jnp.exp(log_p - log_q)
    result = pmc_update(
        params, samples_T, w, rb=True,
        dof_solver_steps=dof_solver_steps if params.is_student_t else 0,
        mindof=mindof, maxdof=maxdof,
        axis_name=axis_name, transposed=True,
    )
    wlogw = jnp.where(w > 0, w * jnp.log(jnp.where(w > 0, w, 1.0)), 0.0)
    sw = psum(jnp.stack([jnp.sum(w), jnp.sum(w * w), jnp.sum(wlogw)]))
    return result, samples_T, w, latent, sw


@partial(jax.jit, static_argnames=("axis_name", "transposed"))
def pmc_log_likelihood(params: _core.MixtureParams, samples,
                       normalized_weights=None, axis_name: Optional[str] = None,
                       transposed: bool = False):
    """Log likelihood according to eq. (5) in [Cap+08]
    (``pmc.pyx:371-391``): the weighted mean of ``log q(x_n)``.  With
    ``axis_name``, inputs are local shards and the reduction is a psum."""
    samples = jnp.asarray(samples)
    if transposed:
        log_q = _core.mixture_logpdf_T(params, samples)
    else:
        log_q = _core.mixture_logpdf(params, samples)

    def psum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    if normalized_weights is None:
        return psum(jnp.sum(log_q)) / psum(jnp.asarray(float(log_q.shape[0])))
    return psum(jnp.sum(log_q * normalized_weights))


# --------------------------------------------------------------------- #
# reference-compatible wrappers                                         #
# --------------------------------------------------------------------- #

def _check_pmc_args(samples, weights, latent, mincount, rb):
    if weights is not None:
        weights = _np.asarray(weights)
        assert len(weights.shape) == 1, "expected a 1-D weight vector"
        assert len(weights) == len(samples), (
            "weight count %s != sample count %s"
            % (len(weights), len(samples))
        )
    if latent is None:
        if mincount > 0:
            raise ValueError("mincount requires latent component indices; pass latent= or set mincount=0")
        if not rb:
            raise ValueError("non-Rao-Blackwellized updates need latent component indices; pass latent= or keep rb=True")
    return weights


def _apply_pmc(density, samples, weights, latent, rb, mincount, copy, **kwargs):
    weights = _check_pmc_args(samples, weights, latent, mincount, rb)
    if copy:
        density = _cp(density)
    params = density.stacked_params()
    latent_arr = None if latent is None else jnp.asarray(_np.asarray(latent))
    result = pmc_update(
        params,
        jnp.asarray(samples),
        None if weights is None else jnp.asarray(weights),
        latent_arr,
        rb=rb,
        mincount=int(mincount),
        **kwargs,
    )
    failed = _np.asarray(result.live & ~result.updated_ok)
    for k in _np.flatnonzero(failed):
        logger.warning("covariance update failed for component %i; zeroing its weight" % k)
    density.set_params(result.params)
    return density


def gaussian_pmc(samples, density, weights=None, latent=None, rb=True,
                 mincount=0, copy=True):
    """Adapt a Gaussian mixture ``density`` with one (M-)PMC update
    ([Cap+08], [Kil+09]) and return the updated density.
    (Reference: ``mix_adapt/pmc.pyx:120-246``.)

    :param samples: ``(N, D)`` array of samples proposed by ``density``.
    :param density: :class:`~pypmc_tpu.density.mixture.MixtureDensity` with
        :class:`~pypmc_tpu.density.gauss.Gauss` components.
    :param weights: optional ``(N,)`` unnormalized importance weights.
    :param latent: optional ``(N,)`` generating-component indices.
    :param rb: Rao-Blackwellize over components (True) or use ``latent``
        one-hot (False; requires ``latent``).
    :param mincount: kill components with fewer than this many samples
        (requires ``latent``).
    :param copy: if True (default) leave ``density`` untouched and return an
        updated copy; else update in place.
    """
    return _apply_pmc(density, samples, weights, latent, rb, mincount, copy,
                      dof_solver_steps=0)


def student_t_pmc(samples, density, weights=None, latent=None, rb=True,
                  dof_solver_steps=100, mindof=1e-5, maxdof=1e3,
                  mincount=0, copy=True):
    """Adapt a Student-t mixture ``density`` with one (M-)PMC update
    ([Cap+08], [Kil+09], [HOD12]) and return the updated density.
    (Reference: ``mix_adapt/pmc.pyx:499-739``.)

    :param dof_solver_steps: bisection iterations for the per-component
        degree-of-freedom first-order condition; 0 keeps the dof fixed.
    :param mindof, maxdof: dof search interval; the root is clamped into it.

    Other parameters as in :func:`gaussian_pmc`.
    """
    return _apply_pmc(density, samples, weights, latent, rb, mincount, copy,
                      dof_solver_steps=int(dof_solver_steps),
                      mindof=float(mindof), maxdof=float(maxdof))


class PMC(object):
    """Adapt a Gaussian or Student-t mixture with repeated (M-)PMC updates
    on the same samples, monitoring the [Cap+08] eq. (5) log-likelihood for
    convergence.  (Reference: ``mix_adapt/pmc.pyx:248-476``.)

    :param samples: ``(N, D)`` array of samples.
    :param density: :class:`~pypmc_tpu.density.mixture.MixtureDensity` with
        Gauss or StudentT components (always copied).
    :param weights, latent, rb, mincount: see :func:`gaussian_pmc`.

    Additional keyword arguments are passed to the underlying PMC update
    (e.g. ``dof_solver_steps`` for Student-t).
    """

    def __init__(self, samples, density, weights=None, latent=None, rb=True,
                 mincount=0, **kwargs):
        # same validation as the functional updates (single source)
        self.weights = _check_pmc_args(samples, weights, latent, mincount, rb)

        error_wrong_mixture = (
            "``density`` must be a ``pypmc_tpu.density.mixture.MixtureDensity`` "
            "with ``pypmc_tpu.density.gauss.Gauss`` or "
            "``pypmc_tpu.density.student_t.StudentT`` components"
        )
        if not isinstance(density, MixtureDensity):
            raise TypeError(error_wrong_mixture)
        if density.kind not in ("gauss", "student_t"):
            raise TypeError(error_wrong_mixture)
        for component in density.components:
            if not isinstance(component, (Gauss, StudentT)):
                raise TypeError(error_wrong_mixture)

        self.density = _cp(density)
        self.samples = samples
        # keep the particles on device ONCE, in the transposed layout
        self._samples_T_dev = jnp.asarray(samples).T
        self.latent = latent
        self._latent_dev = None if latent is None else jnp.asarray(_np.asarray(latent))
        self.rb = rb
        self.mincount = mincount
        self.additional_args = kwargs

        if self.weights is not None:
            self.normalized_weights = self.weights / self.weights.sum()
            self._normalized_weights_dev = jnp.asarray(self.normalized_weights)
            # raw weights stay on device too: _update_once runs up to
            # ~1000 iterations and re-uploading O(N) floats each time is
            # a fresh host->device transfer per iteration
            self._weights_dev = jnp.asarray(self.weights)
        else:
            self._normalized_weights_dev = None
            self._weights_dev = None

    def log_likelihood(self):
        """Log likelihood of the current density, eq. (5) in [Cap+08]."""
        return float(
            pmc_log_likelihood(
                self.density.stacked_params(),
                self._samples_T_dev,
                self._normalized_weights_dev,
                transposed=True,
            )
        )

    def _update_once(self):
        """One PMC update on the cached device-resident (transposed)
        particles; mutates ``self.density``."""
        params = self.density.stacked_params()
        kwargs = dict(self.additional_args)
        if self.density.kind != "student_t":
            kwargs.setdefault("dof_solver_steps", 0)
        result = pmc_update(
            params,
            self._samples_T_dev,
            self._weights_dev,
            self._latent_dev,
            rb=self.rb,
            mincount=int(self.mincount),
            transposed=True,
            **kwargs,
        )
        failed = _np.asarray(result.live & ~result.updated_ok)
        for k in _np.flatnonzero(failed):
            logger.warning("covariance update failed for component %i; zeroing its weight" % k)
        self.density.set_params(result.params)

    def run(self, iterations=1000, prune=0.0, rel_tol=1e-10, abs_tol=1e-5):
        r"""Run PMC updates until convergence of the log-likelihood
        (reference protocol, ``pmc.pyx:393-476``: converge only if the bound
        increased, never on an iteration that changed the number of live
        components; ``prune`` removes components below that weight threshold
        after every update).

        Return the number of iterations at convergence, or None.
        """
        old_K = None
        bound = None
        for i in range(1, iterations + 1):
            if old_K == len(self.density):
                old_bound = bound
            else:
                old_bound = self.log_likelihood()
                logger.info(
                    "K changed to %i; fresh log-likelihood %g",
                    len(self.density), old_bound,
                )

            self._update_once()
            bound = self.log_likelihood()

            logger.info(
                "PMC iteration %d: log-likelihood %.15g with %i live "
                "component(s), weights %s",
                i, bound, len(self.density), self.density.weights,
            )

            if bound < old_bound:
                logger.warning(
                    "log-likelihood dropped this iteration (%g -> %g)",
                    old_bound, bound,
                )

            if bound == old_bound:
                return i
            diff = bound - old_bound
            if diff > 0:
                if abs(bound) < abs_tol:
                    if abs(diff) < abs_tol:
                        return i
                else:
                    if abs(diff / bound) < rel_tol:
                        return i

            old_K = len(self.density)
            self.density.prune(prune)
            self.density.normalize()

        return None
