"""Markov-chain (adaptive Metropolis) sampling on the accelerator.

API-parity re-design of the reference's ``pypmc/sampler/markov_chain.py``.
The reference's per-step Python loop (``markov_chain.py:100-165``) becomes a
``lax.scan`` kernel compiled once per (target, N); the [HST01] covariance
adaptation between runs stays a host computation exactly mirroring the
reference (``markov_chain.py:345-402``).  Many chains run truly in parallel
with :func:`sample_adaptive_chains`, one scan carrying the whole chain pool
-- the device form of the reference's one-Python-object-per-chain
pattern.
"""

from copy import deepcopy as _cp
from functools import partial

import jax
import jax.numpy as jnp
import numpy as _np

from ..tools import History as _History
from ..tools.indicator import merge_function_with_indicator as _indmerge
from ..density.gauss import LocalGauss
from ..density.student_t import LocalStudentT
from .._rng import as_jax_key

import logging

logger = logging.getLogger(__name__)

__all__ = ["MarkovChain", "AdaptiveMarkovChain", "sample_adaptive_chains"]


def _make_mc_kernel(target, dim, is_t):
    """Build the jitted ``lax.scan`` Metropolis kernel for a symmetric local
    Gauss/Student-t proposal.  Carries ``(current, current_eval)``; outputs
    the visited points, their target values, accept flags and NaN flags."""

    def kernel(key, start, start_eval, chol, dof, n):
        # all randomness is drawn in three bulk vectorized passes BEFORE the
        # scan -- per-step key splits + tiny threefry draws inside the loop
        # dominate an otherwise trivial step body
        k_norm, k_chi, k_u = jax.random.split(key, 3)
        z_all = jax.random.normal(k_norm, (n, dim), dtype=start.dtype)
        log_u_all = jnp.log(jax.random.uniform(k_u, (n,), dtype=start.dtype))
        if is_t:
            chi2_all = jax.random.chisquare(k_chi, dof, (n,), dtype=start.dtype)
            z_all = z_all * jnp.sqrt(dof / chi2_all)[:, None]

        def step(carry, xs):
            current, current_eval = carry
            z, log_u = xs
            proposed = current + jnp.matmul(chol, z, precision="highest")
            proposed_eval = target(proposed)
            log_rho = proposed_eval - current_eval  # symmetric proposal
            is_nan = jnp.isnan(log_rho)
            # STRICT vs log_u: uniform [0,1) can draw exactly 0 (log_u
            # = -inf); `>=` would then accept a zero-probability proposal
            # (log_rho = -inf), park the chain out of support and turn the
            # next rejection into a spurious NaN
            accept = (~is_nan) & ((log_rho >= 0) | (log_rho > log_u))
            current = jnp.where(accept, proposed, current)
            current_eval = jnp.where(accept, proposed_eval, current_eval)
            return (current, current_eval), (current, current_eval, accept, is_nan)

        (current, current_eval), (points, evals, accepts, nans) = jax.lax.scan(
            step, (start, start_eval), (z_all, log_u_all)
        )
        return points, evals, jnp.sum(accepts), jnp.any(nans), current, current_eval

    return jax.jit(kernel, static_argnames=("n",))


class MarkovChain(object):
    r"""A Markov chain to generate samples from the target density.
    (Reference: ``markov_chain.py:12-175``.)

    :param target: The log target density: jittable callable
        ``x -> log P(x)``.
    :param proposal: The local proposal density ``q``; a
        :class:`~pypmc_tpu.density.gauss.LocalGauss` or
        :class:`~pypmc_tpu.density.student_t.LocalStudentT` runs the compiled
        ``lax.scan`` device kernel; any other
        :class:`~pypmc_tpu.density.base.LocalDensity` (including asymmetric
        ones, handled with the Metropolis-Hastings ratio) runs on the host.
    :param start: The starting point (must have finite target value and pass
        the indicator).
    :param indicator: Jittable support predicate; points outside are
        rejected without affecting the Metropolis ratio (target ``-inf``).
    :param prealloc: Number of samples to preallocate History memory for.
    :param save_target_values: If True, store ``log P`` at every visited
        point in ``self.target_values``.
    :param rng: int seed or jax PRNG key (device path); a numpy mtrand-style
        generator selects the host path.
    """

    def __init__(self, target, proposal, start, indicator=None,
                 prealloc=0, save_target_values=False, rng=None):
        self.current_point = _np.array(start, dtype=float)
        self.samples = _History(len(self.current_point), prealloc)
        self.proposal = _cp(proposal)
        self.target = _indmerge(target, indicator, -_np.inf)
        from ._target import is_batched, is_transposed

        if is_batched(self.target):
            # the chain kernel evaluates one point at a time
            raw_target = self.target
            if is_transposed(self.target):
                self.target = lambda x: raw_target(jnp.asarray(x)[:, None])[0]
            else:
                self.target = lambda x: raw_target(jnp.asarray(x)[None, :])[0]
        self.target_values = _History(1, prealloc) if save_target_values else None
        self.current_target_eval = float(self.target(self.current_point))
        if not _np.isfinite(self.current_target_eval):
            raise ValueError(
                "``target(start)`` must evaluate to a finite value and "
                "``indicator(start)`` must be ``True``"
            )
        self._numpy_rng = None
        key = as_jax_key(rng)
        if key is None:
            self._numpy_rng = rng
        self._key = key
        self._kernel = None

    def clear(self):
        """Clear the history of visited points; the current chain state is
        untouched."""
        self.samples.clear()
        if self.target_values is not None:
            self.target_values.clear()

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _device_capable(self):
        return self._numpy_rng is None and (
            isinstance(self.proposal, (LocalGauss, LocalStudentT))
        )

    def run(self, N=1, continue_on_NaN=False):
        """Run the chain for ``N`` steps; store visited points into
        ``self.samples``; return the number of accepted proposals.

        :param continue_on_NaN: if False (default), raise ``ValueError`` when
            the target evaluates to NaN at a proposed point; if True, reject
            such points and continue.
        """
        if N == 0:
            return 0
        if not self._device_capable():
            return self._run_host(N, continue_on_NaN)

        if self._kernel is None:
            is_t = isinstance(self.proposal, LocalStudentT)
            self._kernel = _make_mc_kernel(self.target, len(self.current_point), is_t)

        dof = getattr(self.proposal, "dof", 0.0)
        points, evals, accept_count, has_nan, current, current_eval = self._kernel(
            self._next_key(),
            jnp.asarray(self.current_point),
            jnp.asarray(self.current_target_eval),
            jnp.asarray(self.proposal.cholesky_sigma),
            jnp.asarray(dof),
            int(N),
        )
        if bool(has_nan) and not continue_on_NaN:
            raise ValueError("target returned NaN (pass continue_on_NaN=True to reject such proposals)")
        self.samples.append(N)[:] = _np.asarray(points)
        if self.target_values is not None:
            self.target_values.append(N)[:, 0] = _np.asarray(evals)
        self.current_point = _np.asarray(current, dtype=float)
        self.current_target_eval = float(current_eval)
        return int(accept_count)

    def _run_host(self, N, continue_on_NaN):
        """Host fallback: generic/asymmetric proposals or numpy rng
        (reference hot loop, ``markov_chain.py:100-165``)."""
        rng = self._numpy_rng if self._numpy_rng is not None else _np.random.mtrand
        symmetric = getattr(self.proposal, "symmetric", False)
        # local buffers: the Histories are appended only after the loop
        # completes, so a NaN-raise mid-run cannot leave a garbage-filled
        # run behind (the device path raises before appending too)
        this_run = _np.empty((N, len(self.current_point)))
        this_target_values = (_np.empty((N, 1))
                              if self.target_values is not None else None)
        accept_count = 0
        for i_N in range(N):
            proposed_point = _np.asarray(self.proposal.propose(self.current_point, rng))
            proposed_eval = float(self.target(proposed_point))
            log_rho = proposed_eval - self.current_target_eval
            if not symmetric:  # Metropolis-Hastings correction
                log_rho -= float(self.proposal.evaluate(proposed_point, self.current_point))
                log_rho += float(self.proposal.evaluate(self.current_point, proposed_point))
            if _np.isnan(log_rho):
                if not continue_on_NaN:
                    raise ValueError("target returned NaN (pass continue_on_NaN=True to reject such proposals)")
                this_run[i_N] = self.current_point
            elif log_rho >= 0 or log_rho > _np.log(rng.rand()):
                accept_count += 1
                this_run[i_N] = proposed_point
                self.current_point = proposed_point
                self.current_target_eval = proposed_eval
            else:
                this_run[i_N] = self.current_point
            if self.target_values is not None:
                this_target_values[i_N] = self.current_target_eval
        self.samples.append(N)[:] = this_run
        if self.target_values is not None:
            self.target_values.append(N)[:] = this_target_values
        return accept_count


class AdaptiveMarkovChain(MarkovChain):
    r"""A Markov chain with [HST01] proposal-covariance adaptation.
    (Reference: ``markov_chain.py:177-402``.)

    Between runs, :meth:`adapt` combines the sample covariance of the last
    run with the previous estimate using a damping weight ``1/t^damping``,
    and rescales by ``covar_scale_factor`` which is multiplied/divided by
    ``covar_scale_multiplier`` to force the acceptance rate into
    ``[force_acceptance_min, force_acceptance_max]``.
    """

    def __init__(self, *args, **kwargs):
        self.adapt_count = 1

        self.covar_scale_multiplier = kwargs.pop("covar_scale_multiplier", 1.5)
        self.covar_scale_factor = kwargs.pop("covar_scale_factor", None)
        self.covar_scale_factor_max = kwargs.pop("covar_scale_factor_max", 100.0)
        self.covar_scale_factor_min = kwargs.pop("covar_scale_factor_min", 0.0001)
        self.force_acceptance_max = kwargs.pop("force_acceptance_max", 0.35)
        self.force_acceptance_min = kwargs.pop("force_acceptance_min", 0.15)
        self.damping = kwargs.pop("damping", 0.5)

        super(AdaptiveMarkovChain, self).__init__(*args, **kwargs)

        if self.covar_scale_factor is None:
            self.covar_scale_factor = 2.38**2 / len(self.current_point)

        self.unscaled_sigma = _np.asarray(self.proposal.sigma) / self.covar_scale_factor

    def run(self, N=1, continue_on_NaN=False):
        if N == 0:
            return 0
        self._last_accept_count = super(AdaptiveMarkovChain, self).run(N, continue_on_NaN)
        return self._last_accept_count

    def set_adapt_params(self, *args, **kwargs):
        r"""Set the variables for covariance adaptation:
        ``covar_scale_multiplier``, ``covar_scale_factor``,
        ``covar_scale_factor_max/min``, ``force_acceptance_max/min``,
        ``damping``.  (Reference: ``markov_chain.py:217-342``.)"""
        if args != ():
            raise TypeError("positional arguments are not accepted; use set_adapt_params(name=value)")

        self.covar_scale_multiplier = kwargs.pop("covar_scale_multiplier", self.covar_scale_multiplier)
        self.covar_scale_factor = kwargs.pop("covar_scale_factor", self.covar_scale_factor)
        self.covar_scale_factor_max = kwargs.pop("covar_scale_factor_max", self.covar_scale_factor_max)
        self.covar_scale_factor_min = kwargs.pop("covar_scale_factor_min", self.covar_scale_factor_min)
        self.force_acceptance_max = kwargs.pop("force_acceptance_max", self.force_acceptance_max)
        self.force_acceptance_min = kwargs.pop("force_acceptance_min", self.force_acceptance_min)
        self.damping = kwargs.pop("damping", self.damping)

        if kwargs:
            raise TypeError("unknown adaptation parameter(s): " + str(kwargs.keys()))

    def adapt(self):
        r"""Update the proposal covariance using the points of the last run
        ([HST01] damped estimate + acceptance-band rescaling).  Falls back
        full -> diagonal -> shrink-old on invalid covariance.
        (Reference: ``markov_chain.py:345-391``.)"""
        last_run = self.samples[-1]
        accept_rate = float(self._last_accept_count) / len(last_run)

        covar_estimator = _np.cov(last_run, rowvar=0)

        time_dependent_damping_factor = 1.0 / self.adapt_count**self.damping
        self.unscaled_sigma = (
            (1 - time_dependent_damping_factor) * self.unscaled_sigma
            + time_dependent_damping_factor * covar_estimator
        )
        self._update_scale_factor(accept_rate)
        scaled_sigma = self.covar_scale_factor * self.unscaled_sigma

        self.adapt_count += 1

        try:
            self.proposal.update(scaled_sigma)
        except _np.linalg.LinAlgError:
            logger.warning("full-covariance proposal update was not PD; retrying with the diagonal only")
            diagonal_matrix = _np.diag(_np.diag(scaled_sigma))
            try:
                self.proposal.update(diagonal_matrix)
                logger.warning("diagonal-only update accepted")
            except _np.linalg.LinAlgError:
                logger.warning("diagonal-only update not PD either; shrinking the old covariance")
                self.proposal.update(self.proposal.sigma / self.covar_scale_multiplier)

    def _update_scale_factor(self, accept_rate):
        """Multiply/divide ``covar_scale_factor`` to force the acceptance
        rate into the configured band, within its limits."""
        if (
            accept_rate > self.force_acceptance_max
            and self.covar_scale_factor < self.covar_scale_factor_max
        ):
            self.covar_scale_factor *= self.covar_scale_multiplier
        elif (
            accept_rate < self.force_acceptance_min
            and self.covar_scale_factor > self.covar_scale_factor_min
        ):
            self.covar_scale_factor /= self.covar_scale_multiplier


def sample_adaptive_chains(target, starts, sigma0, n_steps, n_adapt_cycles,
                           key=None, dof=None, indicator=None,
                           continue_on_NaN=False, **adapt_kwargs):
    """Multi-chain adaptive Metropolis: run ``C`` chains fully in parallel,
    one ``lax.scan`` over the steps carrying the whole ``(C, D)`` chain state,
    adapting each chain's proposal covariance between cycles with the
    [HST01] rule.

    This replaces the reference pattern of looping over per-chain Python
    objects (``examples/uniting_markov_chains_and_variational_bayes.py:72-87``)
    with one compiled computation per cycle.

    :param target: jittable ``x -> log P(x)``, or a
        :class:`~pypmc_tpu.density.core.MixtureParams` target (evaluated with
        :func:`~pypmc_tpu.density.core.mixture_logpdf`).
    :param starts: ``(C, D)`` starting points (each must have finite target).
    :param sigma0: ``(D, D)`` or ``(C, D, D)`` initial proposal covariance.
    :param n_steps: steps per adaptation cycle.
    :param n_adapt_cycles: number of cycles; total steps = product.
    :param key: jax PRNG key (or None for seed 0).
    :param dof: Student-t proposal dof (scalar) or None for Gaussian.
    :param indicator: optional jittable predicate ``x -> bool``; proposals
        outside its support evaluate to ``-inf`` and are always rejected
        (the reference merges indicators into the target the same way,
        ``sampler/markov_chain.py:82``).
    :param continue_on_NaN: as :meth:`MarkovChain.run` -- ``False``
        (default) raises :class:`ValueError` if any proposal's target value
        came out NaN; ``True`` silently rejects such proposals and keeps
        the chains running.

    Returns ``(samples (C, n_cycles*n_steps, D), accept_rates (C, n_cycles))``.
    """
    from ..density import core as _core

    starts = jnp.asarray(starts)
    C, D = starts.shape
    if key is None:
        key = jax.random.PRNGKey(0)

    if isinstance(target, _core.MixtureParams):
        mix_target = target
        target = lambda x: _core.mixture_logpdf(mix_target, x[None, :])[0]

    if indicator is not None:
        target = _indmerge(target, indicator, -jnp.inf)

    covar_scale_multiplier = adapt_kwargs.pop("covar_scale_multiplier", 1.5)
    covar_scale_factor = adapt_kwargs.pop("covar_scale_factor", 2.38**2 / D)
    covar_scale_factor_max = adapt_kwargs.pop("covar_scale_factor_max", 100.0)
    covar_scale_factor_min = adapt_kwargs.pop("covar_scale_factor_min", 0.0001)
    force_acceptance_max = adapt_kwargs.pop("force_acceptance_max", 0.35)
    force_acceptance_min = adapt_kwargs.pop("force_acceptance_min", 0.15)
    damping = adapt_kwargs.pop("damping", 0.5)
    if adapt_kwargs:
        raise TypeError("unknown adaptation parameter(s): " + str(adapt_kwargs.keys()))

    sigma0 = jnp.asarray(sigma0)
    if sigma0.ndim == 2:
        sigma0 = jnp.broadcast_to(sigma0, (C, D, D))

    is_t = dof is not None
    dof_val = jnp.asarray(0.0 if dof is None else dof)

    @partial(jax.jit, static_argnames=("n",))
    def all_chains_cycle(key, currents, current_evals, chols, n):
        # ONE scan over the step axis carrying the whole (C, D) chain-state
        # block.  All randomness is bulk-drawn up front in STEP-major layout
        # so every scan iteration reads a contiguous (C, D) slice -- both
        # per-step threefry draws and chain-major (C, n, D) slicing (a
        # strided gather per step) measurably dominate the tiny step body.
        k_norm, k_chi, k_u = jax.random.split(key, 3)
        z_all = jax.random.normal(k_norm, (n, C, D), dtype=starts.dtype)
        log_u_all = jnp.log(jax.random.uniform(k_u, (n, C), dtype=starts.dtype))
        if is_t:
            chi2_all = jax.random.chisquare(k_chi, dof_val, (n, C),
                                            dtype=starts.dtype)
            z_all = z_all * jnp.sqrt(dof_val / chi2_all)[..., None]
        vtarget = jax.vmap(target)

        def step(carry, xs):
            current, current_eval = carry
            z, log_u = xs
            proposed = current + jnp.einsum("cde,ce->cd", chols, z, precision="highest")
            proposed_eval = vtarget(proposed)
            log_rho = proposed_eval - current_eval
            is_nan = jnp.isnan(log_rho)
            accept = (~is_nan) & ((log_rho >= 0) | (log_rho > log_u))
            current = jnp.where(accept[:, None], proposed, current)
            current_eval = jnp.where(accept, proposed_eval, current_eval)
            return (current, current_eval), (current, accept, is_nan)

        (currents, current_evals), (points, accepts, nans) = jax.lax.scan(
            step, (currents, current_evals), (z_all, log_u_all)
        )
        return (points.transpose(1, 0, 2),
                jnp.mean(accepts.astype(starts.dtype), axis=0),
                jnp.sum(nans), currents, current_evals)

    @jax.jit
    def adapt_step(unscaled_sigma, scale_factor, points, accept_rate, adapt_count):
        # damped covariance estimate, [HST01]
        mean = jnp.mean(points, axis=0)
        diff = points - mean[None, :]
        covar = jnp.matmul(diff.T, diff, precision="highest") / (points.shape[0] - 1)
        a_t = 1.0 / adapt_count**damping
        unscaled_sigma = (1 - a_t) * unscaled_sigma + a_t * covar
        scale_factor = jnp.where(
            (accept_rate > force_acceptance_max) & (scale_factor < covar_scale_factor_max),
            scale_factor * covar_scale_multiplier,
            jnp.where(
                (accept_rate < force_acceptance_min) & (scale_factor > covar_scale_factor_min),
                scale_factor / covar_scale_multiplier,
                scale_factor,
            ),
        )
        scaled = scale_factor * unscaled_sigma
        chol = jnp.linalg.cholesky(scaled)
        # fallback full -> diagonal -> shrink-old on invalid covariance
        diag_chol = jnp.linalg.cholesky(jnp.diag(jnp.diag(scaled)))
        ok_full = jnp.all(jnp.isfinite(chol))
        ok_diag = jnp.all(jnp.isfinite(diag_chol))
        chol = jnp.where(ok_full, chol, jnp.where(ok_diag, diag_chol, jnp.nan))
        return unscaled_sigma, scale_factor, chol, ok_full | ok_diag

    current = starts
    current_eval = jax.vmap(target)(starts)
    bad_starts = _np.flatnonzero(~_np.isfinite(_np.asarray(current_eval)))
    if bad_starts.size:
        raise ValueError(
            "target is not finite at %d starting point(s) (first offenders: "
            "%s)" % (bad_starts.size, bad_starts[:5].tolist())
        )
    chols = jnp.linalg.cholesky(sigma0)
    unscaled = sigma0 / covar_scale_factor
    scale_factors = jnp.full((C,), covar_scale_factor, dtype=starts.dtype)

    all_samples = []
    all_rates = []
    nan_counts = []
    for cycle in range(n_adapt_cycles):
        key, sub = jax.random.split(key)
        points, rates, nan_count, current, current_eval = all_chains_cycle(
            sub, current, current_eval, chols, int(n_steps)
        )
        # defer the host materialization: an int() here would force a
        # device sync EVERY cycle; the policy check runs once after the loop
        nan_counts.append(nan_count)
        all_samples.append(points)
        all_rates.append(rates)
        unscaled, scale_factors, new_chols, ok = jax.vmap(adapt_step)(
            unscaled, scale_factors, points,
            rates, jnp.full((C,), cycle + 1.0, dtype=starts.dtype),
        )
        # shrink-old fallback where both cholesky attempts failed
        old_scaled = jnp.einsum("cij,ckj->cik", chols, chols,
                                precision="highest") / covar_scale_multiplier
        fallback_chol = jnp.linalg.cholesky(old_scaled)
        chols = jnp.where(ok[:, None, None], new_chols, fallback_chol)

    if not continue_on_NaN:
        counts = _np.asarray(jnp.stack(nan_counts))  # ONE sync for the run
        bad = _np.flatnonzero(counts > 0)
        if bad.size:
            raise ValueError(
                "target returned NaN for %d proposal(s), first in adaptation "
                "cycle %d (pass continue_on_NaN=True to reject such "
                "proposals)" % (int(counts.sum()), int(bad[0]))
            )
    samples = jnp.stack(all_samples, axis=1).reshape(C, n_adapt_cycles * n_steps, D)
    return samples, jnp.stack(all_rates, axis=1)
