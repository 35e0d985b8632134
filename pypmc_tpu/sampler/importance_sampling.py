"""Importance sampling on the accelerator.

API-parity re-design of the reference's
``pypmc/sampler/importance_sampling.py``.  The reference computes importance
weights in a per-sample Python loop (``importance_sampling.py:197-215``); here
the whole propose -> evaluate-proposal -> evaluate-target -> weights step is
ONE jitted XLA computation over the full particle batch, with the target
``vmap``-ed over particles.  The estimator reductions are written as sums
over the particle axis so they shard/``psum`` transparently (see
:mod:`pypmc_tpu.parallel`).
"""

from copy import deepcopy as _cp
from functools import partial

import jax
import jax.numpy as jnp
import numpy as _np

from ..density import core as _core
from ..density.mixture import MixtureDensity
from ..ops.lse import logsumexp
from ..tools import History as _History
from ..tools.indicator import merge_function_with_indicator as _indmerge
from ._target import evaluate_target_T
from .._rng import RNG_DEFAULT, as_jax_key

__all__ = [
    "ImportanceSampler",
    "calculate_expectation",
    "calculate_mean",
    "calculate_covariance",
    "combine_weights",
]


def calculate_expectation(samples, weights, f):
    r"""Expectation value :math:`\sum_n \bar w_n f(x_n)` of function ``f``
    under self-normalized weights.  ``f`` is ``vmap``-ed over samples when
    jittable, with a host-loop fallback.
    (Reference: ``importance_sampling.py:13-44``.)"""
    assert len(samples) == len(weights), (
        "got %i samples but %i weights"
        % (len(samples), len(weights))
    )
    weights = jnp.asarray(weights)
    try:
        values = jax.vmap(f)(jnp.asarray(samples))
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError,
            jax.errors.TracerBoolConversionError,
            jax.errors.TracerIntegerConversionError):
        # ``f`` is genuinely untraceable (escapes the tracer) -- evaluate in
        # a host loop.  Any other error is a real bug in ``f`` and propagates.
        values = jnp.asarray(_np.array([f(_np.asarray(x)) for x in _np.asarray(samples)]))
    return (jnp.einsum("n,n...->...", weights, values, precision="highest")
            / jnp.sum(weights))


def calculate_mean(samples, weights):
    """Mean of weighted samples.  (Reference: ``importance_sampling.py:46-60``.)"""
    assert len(samples) == len(weights), (
        "got %i samples but %i weights"
        % (len(samples), len(weights))
    )
    samples = jnp.asarray(samples)
    weights = jnp.asarray(weights)
    return jnp.einsum("n,ni->i", weights, samples, precision="highest") / jnp.sum(weights)


def calculate_covariance(samples, weights):
    """Unbiased covariance matrix of weighted samples, with the reference's
    weighted-unbiasing factor (``importance_sampling.py:62-83``)."""
    assert len(samples) == len(weights), (
        "got %i samples but %i weights"
        % (len(samples), len(weights))
    )
    samples = jnp.asarray(samples)
    weights = jnp.asarray(weights)
    sum_w = jnp.sum(weights)
    sum_weights_sq = sum_w**2
    sum_sq_weights = jnp.sum(weights**2)
    mean = jnp.einsum("n,ni->i", weights, samples, precision="highest") / sum_w
    diff = samples - mean[None, :]
    cov = jnp.einsum("n,ni,nj->ij", weights, diff, diff,
                     precision="highest") / sum_w
    return sum_weights_sq / (sum_weights_sq - sum_sq_weights) * cov


class ImportanceSampler(object):
    r"""An importance sampler: generates weighted samples from ``target``
    using ``proposal``.  (Reference: ``importance_sampling.py:132-236``.)

    :param target: The log target density: callable ``x -> log P(x)`` for a
        1d array ``x``.  For the device path it must be jittable (traceable
        by JAX); non-jittable targets fall back to a host loop.
    :param proposal: The proposal density ``q``
        (:class:`pypmc_tpu.density.mixture.MixtureDensity` for the batched
        device path, any :class:`~pypmc_tpu.density.base.ProbabilityDensity`
        otherwise).
    :param indicator: Jittable predicate restricting the support; proposed
        points outside get zero weight (target value ``-inf``).
    :param prealloc: Number of samples for which History memory is
        preallocated.
    :param save_target_values: If True, store ``log P`` at every visited
        point in ``self.target_values``.
    :param rng: int seed, jax PRNG key (device path, default seed 0), or a
        numpy mtrand-style generator (host path, reference-compatible).
    """

    def __init__(self, target, proposal, indicator=None, prealloc=0,
                 save_target_values=False, rng=None):
        self.proposal = _cp(proposal)
        self.target = _indmerge(target, indicator, -_np.inf)
        self.target_values = _History(1, prealloc) if save_target_values else None
        self.weights = _History(1, prealloc)
        self.samples = _History(proposal.dim, prealloc)
        self._numpy_rng = None
        key = as_jax_key(rng)
        if key is None:  # numpy-style generator
            self._numpy_rng = rng
        self._key = key
        self._step = None  # compiled device step, built lazily
        self._target_not_jittable = False  # set on first failed trace
        # device-resident runs not yet flushed to the host Histories:
        # (samples_T (D, n), weights (n,), log_p (n,) or None)
        self._device_pending = []

    def clear(self):
        """Clear the history of samples, weights (and target values) AND
        drop any device-resident pending runs."""
        self.samples.clear()
        self.weights.clear()
        if self.target_values is not None:
            self.target_values.clear()
        self._device_pending = []

    @property
    def device_runs(self):
        """Device-resident ``(samples_T, weights)`` tuples of the runs not
        yet flushed to the host Histories (``to_host=False`` runs); pass
        them straight to :func:`combine_weights` / the adaptation updates
        to avoid the O(N*D) host round-trip entirely."""
        return [(s, w) for s, w, _ in self._device_pending]

    def gather(self):
        """Flush all device-resident runs into the host Histories.
        Returns the number of runs flushed."""
        flushed = 0
        for samples_T, weights, log_p in self._device_pending:
            n = samples_T.shape[1]
            self.samples.append(n)[:] = _np.asarray(samples_T).T
            self.weights.append(n)[:, 0] = _np.asarray(weights)
            if self.target_values is not None and log_p is not None:
                self.target_values.append(n)[:, 0] = _np.asarray(log_p)
            flushed += 1
        self._device_pending = []
        return flushed

    # ------------------------------------------------------------------ #

    def _build_step(self):
        target = self.target

        @partial(jax.jit, static_argnames=("n",))
        def step(params, key, n):
            # particles stay transposed (D, n) on device; the host History
            # receives the (n, D) view for free
            samples_T, latent, log_q = _core.propose_logq_T(params, key, n)
            log_p = evaluate_target_T(target, samples_T)
            weights = jnp.exp(log_p - log_q)
            return samples_T, latent, weights, log_p

        return step

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def run(self, N=1, trace_sort=False, to_host=True):
        """Run the sampler for ``N`` points; store samples into
        ``self.samples`` and importance weights into ``self.weights``.

        With ``to_host=False`` (device path only) the run stays resident on
        the device (:attr:`device_runs`) and the O(N*D) host transfer is
        deferred to :meth:`gather` or the next ``to_host=True`` run --
        feed the device arrays straight to :func:`combine_weights` or the
        adaptation updates.

        If ``trace_sort``, return the index of the responsible proposal
        component for each sample (the samples are NOT component-sorted --
        the device path draws per-particle categorical components, which is the
        same distribution without the ordering artifact).
        """
        if N == 0:
            return 0

        use_device = (
            self._numpy_rng is None
            and not self._target_not_jittable
            and isinstance(self.proposal, MixtureDensity)
            and self.proposal.kind != "generic"
        )
        if use_device:
            if self._step is None:
                self._step = self._build_step()
            params = self.proposal.stacked_params()
            try:
                samples_T, latent, weights, log_p = self._step(params, self._next_key(), int(N))
            except (jax.errors.TracerArrayConversionError,
                    jax.errors.ConcretizationTypeError):
                # a non-jittable target fails the SAME way every time;
                # remember it so later runs skip the full doomed re-trace
                # (failed traces are not cached by jax)
                self._target_not_jittable = True
                use_device = False
        if not use_device:
            return self._run_host(N, trace_sort)

        self._device_pending.append(
            (samples_T, weights,
             log_p if self.target_values is not None else None))
        if to_host:
            self.gather()
        if trace_sort:
            return _np.asarray(latent) if to_host else latent
        return None

    def _run_host(self, N, trace_sort):
        """Host fallback: numpy rng and/or non-jittable target."""
        # flush device-resident runs first so History order stays
        # chronological
        self.gather()
        rng = self._numpy_rng if self._numpy_rng is not None else RNG_DEFAULT
        if trace_sort:
            this_samples, origin = self.proposal.propose(N, rng, trace=True, shuffle=False)
        else:
            origin = None
            this_samples = self.proposal.propose(N, rng)
        log_q = _np.asarray(self.proposal.multi_evaluate(_np.asarray(this_samples)))
        targets = _np.empty(N)
        for i in range(N):
            targets[i] = float(self.target(this_samples[i]))
        # append the Histories only AFTER the (user) target evaluated on
        # every sample: an exception mid-loop must not leave a garbage
        # weights run without its samples run (permanently out of sync)
        self.weights.append(N)[:, 0] = _np.exp(targets - log_q)
        self.samples.append(N)[:] = this_samples
        if self.target_values is not None:
            self.target_values.append(N)[:, 0] = targets
        return origin


def combine_weights(samples, weights, proposals):
    """Deterministic-mixture (AMIS) weights according to [Cor+12] for
    several importance-sampling runs with the same target but different
    proposals; return a :class:`~pypmc_tpu.tools.History` with one run per
    proposal.  (Reference: ``importance_sampling.py:238-371``.)"""
    # host numpy stays host; jax arrays stay ON DEVICE (a
    # device-resident run from ``run(to_host=False)`` combines with zero
    # host round-trips -- pass ``sampler.device_runs`` entries as
    # ``samples[t].T`` / ``weights[t]``)
    samples = [s if isinstance(s, jax.Array) else _np.asarray(s)
               for s in samples]
    weights = [w if isinstance(w, jax.Array) else _np.asarray(w)
               for w in weights]

    assert len(samples) == len(weights), (
        "%i sample runs vs %i weight runs -- counts must agree" % (len(samples), len(weights))
    )
    assert len(samples) == len(proposals), (
        "%i sample runs vs %i proposals -- counts must agree"
        % (len(samples), len(proposals))
    )

    dim = samples[0].shape[-1]
    N = _np.empty(len(proposals))
    N_total = 0
    for i in range(len(N)):
        assert samples[i].ndim == 2, "samples[%i] must be a 2-D array" % i
        assert samples[i].shape[-1] == dim, (
            "samples[0] has dimension %i but samples[%i] has %i"
            % (dim, i, samples[i].shape[-1])
        )
        N[i] = len(samples[i])
        N_total += int(N[i])
        assert N[i] == len(weights[i]), (
            "weights[%i] has length %i but samples[%i] has %i"
            % (i, len(weights[i]), i, N[i])
        )

    history = _History(1, N_total)
    # the linear path exists ONLY for negative weights (it evaluates
    # exp(log q), which underflows to 0/0 at high dimension); weights that
    # are exactly 0 -- e.g. float32-underflowed w = exp(log p - log q) --
    # stay on the log path, where log(0) = -inf propagates to a combined
    # weight of exactly 0
    any_negative = any((w < 0.0).any() for w in weights)
    if not any_negative:
        _combine_weights_log(samples, weights, proposals, history, N_total, N)
    else:
        _combine_weights_linear(samples, weights, proposals, history, N_total, N)

    assert _np.isfinite(history[:][:, 0]).all(), "combined mixture weights contain inf/nan"
    return history


def _stacked_proposal_params(proposals):
    """Stacked device parameters for every proposal, or None if any
    proposal is not a batched-evaluable mixture (host fallback)."""
    if all(isinstance(p, MixtureDensity) and p.kind != "generic"
           for p in proposals):
        return [p.stacked_params() for p in proposals]
    return None


def _all_proposal_log_q(y, proposals):
    """``(N_t, T)`` log-densities of ONE run's samples under ALL proposals
    (host fallback for generic proposals; stacked mixture proposals take
    the device path through :func:`_combine_one_run_device` instead)."""
    return jnp.asarray(_np.column_stack(
        [_np.asarray(p.multi_evaluate(_np.asarray(y))) for p in proposals]))


@partial(jax.jit, static_argnames=("linear",))
def _combine_one_run_device(yT, w_t, t, n_arr, params_list, linear=False):
    """[Cor+12] Eq. (3) combined weights of ONE run's samples, fully on
    device: all T proposal evaluations and the mixture denominator execute
    as a single dispatch (run index ``t`` is a traced scalar, so every run
    reuses the one compiled executable)."""
    q = jnp.stack(
        [_core.mixture_logpdf_T(p, yT) for p in params_list], axis=-1)
    w_t = jnp.asarray(w_t, dtype=q.dtype)
    n_arr = jnp.asarray(n_arr, dtype=q.dtype)
    n_total = jnp.sum(n_arr)
    q_t = jnp.take(q, t, axis=1)
    if linear:
        denominator = jnp.einsum("l,nl->n", n_arr / n_total, jnp.exp(q),
                                 precision="highest")
        return jnp.exp(q_t) * w_t / denominator
    log_w = jnp.log(w_t) + q_t + jnp.log(n_total) - logsumexp(q, n_arr, axis=-1)
    return jnp.exp(log_w)


def _combine_weights_device(samples, weights, proposals, history, N, params,
                            linear):
    # upload in the PROPOSAL parameter dtype (float32 on an accelerator):
    # the device math runs at that precision anyway, and the host Histories
    # hold float64 -- casting host-side halves the upload volume (at 10^7
    # samples x D=20 that is ~1.6 GB -> 0.8 GB)
    dtype = _np.asarray(params[0].means).dtype
    for t in range(len(proposals)):
        combined = history.append(N[t])
        if isinstance(samples[t], jax.Array):
            yT = samples[t].T.astype(dtype)   # already on device, no copy
            w_t = jnp.asarray(weights[t], dtype=dtype)
        else:
            yT = jnp.asarray(_np.asarray(samples[t], dtype=dtype).T)
            w_t = _np.asarray(weights[t], dtype=dtype)
        combined[:, 0] = _np.asarray(_combine_one_run_device(
            yT, w_t, jnp.asarray(t, jnp.int32), N, params, linear=linear))
    return history


def _combine_weights_log(samples, weights, proposals, history, N_total, N):
    # [Cor+12] Eq. (3) on the log scale:
    # log w_i^t = log(omega_i^t) + log q_t(y_i^t) + log(N_total)
    #             - log(sum_l N_l exp(log q_l(y_i^t)))
    params = _stacked_proposal_params(proposals)
    if params is not None:
        _combine_weights_device(samples, weights, proposals, history, N,
                                params, linear=False)
    else:
        for t in range(len(proposals)):
            combined = history.append(N[t])
            q = _all_proposal_log_q(samples[t], proposals)
            n_arr = jnp.asarray(N, dtype=q.dtype)
            log_w_t = (jnp.log(jnp.asarray(weights[t], dtype=q.dtype))
                       + q[:, t] + jnp.log(jnp.asarray(N_total, dtype=q.dtype))
                       - logsumexp(q, n_arr, axis=-1))
            combined[:, 0] = _np.asarray(jnp.exp(log_w_t))

    sum_w = history[:][:, 0].sum()
    assert sum_w > 0, "total combined weight must be positive, got %g" % sum_w
    return history


def _combine_weights_linear(samples, weights, proposals, history, N_total, N):
    # [Cor+12] Eq. (3) on the linear scale (needed for negative weights)
    params = _stacked_proposal_params(proposals)
    if params is not None:
        return _combine_weights_device(samples, weights, proposals, history,
                                       N, params, linear=True)
    for t in range(len(proposals)):
        combined = history.append(N[t])
        q = _all_proposal_log_q(samples[t], proposals)
        n_arr = jnp.asarray(N, dtype=q.dtype)
        denominator = jnp.einsum("l,nl->n", n_arr / N_total, jnp.exp(q),
                                 precision="highest")
        numerator = (jnp.exp(q[:, t])
                     * jnp.asarray(weights[t], dtype=q.dtype))
        combined[:, 0] = _np.asarray(numerator / denominator)
    return history
