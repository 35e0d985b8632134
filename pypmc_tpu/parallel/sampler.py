"""Data-parallel importance sampling and PMC over a device mesh.

Device-mesh replacement for the reference's ``MPISampler``
(``tools/parallel_sampler.py:7-80``) and the MPI PMC pipeline
(``examples/pmc_mpi.py``): instead of "every rank samples, gather O(N*D)
samples to rank 0, adapt centrally, broadcast the proposal back", the
particle axis is sharded over all devices with ``shard_map``, every device
computes local sufficient statistics, and ONE ``psum`` of O(K*D^2) data makes
every device hold the identical updated mixture -- the proposal broadcast
disappears entirely.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as _np
from jax.sharding import PartitionSpec as P

from ..density import core as _core
from ..mix_adapt.pmc import pmc_log_likelihood, pmc_update
from ..tools import History as _History
from ..tools.indicator import merge_function_with_indicator as _indmerge
from .._rng import as_jax_key
from .mesh import PARTICLE_AXIS, particle_mesh

import logging

logger = logging.getLogger(__name__)

__all__ = ["ParallelSampler", "run_is_step_sharded", "pmc_run_sharded",
           "PMCStepStats", "clear_step_cache"]

# Compiled-step LRU cache, keyed on everything the trace depends on (incl.
# the target function object itself).  Bounded: entries pin their targets
# and compiled executables alive, so callers passing many ephemeral
# lambdas/closures evict the oldest instead of leaking for the process
# lifetime.  Re-tracing an evicted step only costs the (cached) jax trace;
# the XLA executable cache underneath is managed by jax itself.
from collections import OrderedDict as _OrderedDict

_STEP_CACHE = _OrderedDict()
_STEP_CACHE_MAX = 32


def _step_cache_get(key):
    if key is None:
        return None
    step = _STEP_CACHE.get(key)
    if step is not None:
        _STEP_CACHE.move_to_end(key)
    return step


def _step_cache_put(key, step):
    if key is None:
        return
    _STEP_CACHE[key] = step
    _STEP_CACHE.move_to_end(key)
    while len(_STEP_CACHE) > _STEP_CACHE_MAX:
        _STEP_CACHE.popitem(last=False)


def clear_step_cache():
    """Drop all cached compiled sharded steps (releases the target callables
    and executables they pin)."""
    _STEP_CACHE.clear()


def _is_body(params, key, n_local, target):
    """Per-shard importance-sampling step: propose, evaluate, weight.
    Particles are carried transposed ``(D, n_local)``.

    Propose and proposal-log-q run as one jitted step
    (:func:`~pypmc_tpu.density.core.propose_logq_T`); a MIXTURE target
    (passed as :class:`~pypmc_tpu.density.core.MixtureParams`) is evaluated
    in the same step."""
    from ..sampler._target import evaluate_target_T

    if isinstance(target, _core.MixtureParams):
        samples_T, latent, log_q, log_p = _core.propose_logq_T(
            params, key, n_local, target)
    else:
        samples_T, latent, log_q = _core.propose_logq_T(params, key, n_local)
        log_p = evaluate_target_T(target, samples_T)
    weights = jnp.exp(log_p - log_q)
    return samples_T, weights, latent


def _target_token(target):
    """Hashable cache token + call-time argument for a target.

    Mixture targets (:class:`~pypmc_tpu.density.core.MixtureParams`) are
    pytrees of (unhashable) arrays whose VALUES must be runtime arguments
    of the compiled step -- baking them in as closure constants would make
    the cache return stale compilations for different target parameters.
    Callable targets are hashable and closure-captured as before.

    Returns ``(token, tp, target_in_body)`` where ``tp`` is the extra
    runtime argument (``()`` for callables) and ``target_in_body(tp)``
    recovers the target inside the traced body."""
    if isinstance(target, _core.MixtureParams):
        token = ("mixture_target", target.K, target.dim, target.is_student_t)
        return token, target, lambda tp: tp
    try:
        hash(target)
    except TypeError:
        # an unhashable callable (e.g. a dataclass with eq=True) cannot be
        # a cache key; id() would risk serving a STALE step after id reuse,
        # so such targets simply skip the cache (token None)
        return None, (), lambda tp: target
    return target, (), lambda tp: target


def run_is_step_sharded(params, target, key, n_total, mesh=None,
                        axis_name=PARTICLE_AXIS):
    """Draw ``n_total`` importance samples with the particle axis sharded
    over ``mesh``; return globally-sharded ``(samples_T (D, n_total),
    weights, latent)`` -- particles in the transposed device layout.
    ``n_total`` is rounded UP to the next multiple of the mesh size when
    not divisible (the arrays are sized accordingly).

    ``target`` is a jittable log-density callable, or a
    :class:`~pypmc_tpu.density.core.MixtureParams` (then the target is
    evaluated in the same step as the proposal draw).

    Each shard folds the key with its mesh position, so results are
    deterministic for a fixed mesh size (the reference instead broadcasts a
    seed per MPI rank, ``examples/pmc_mpi.py:73-78``).
    """
    if mesh is None:
        mesh = particle_mesh()
    n_dev = mesh.devices.size
    n_local = -(-int(n_total) // n_dev)   # ceil: any n_total is accepted
    if n_local * n_dev != n_total:
        logger.info(
            "n_total=%d is not divisible by %d devices; drawing %d instead",
            n_total, n_dev, n_local * n_dev)

    token, tp, target_of = _target_token(target)
    cache_key = (None if token is None
                 else ("is_step", token, mesh, n_local, axis_name))
    step = _step_cache_get(cache_key)
    if step is None:
        # check_vma=False: the Pallas kernel's out_shape carries no
        # varying-manual-axes annotation, which the shard_map replication
        # checker (correctly) refuses; replication correctness is covered by
        # the sharded-equals-serial tests
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=(P(None, axis_name), P(axis_name), P(axis_name)),
            check_vma=False,
        )
        def step(params, tp, key):
            my_key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
            return _is_body(params, my_key, n_local, target_of(tp))

        step = jax.jit(step)
        _step_cache_put(cache_key, step)

    return step(params, tp, key)


class PMCStepStats(NamedTuple):
    log_likelihood: jax.Array  # [Cap+08] eq. (5) of the UPDATED mixture
    perplexity: jax.Array      # normalized perplexity of the weights
    ess: jax.Array             # normalized effective sample size
    evidence: jax.Array        # mean weight = integral estimate


def pmc_run_sharded(target, params, n_total, n_steps, mesh=None, key=None,
                    rb=True, dof_solver_steps=100, mindof=1e-5, maxdof=1e3,
                    axis_name=PARTICLE_AXIS, return_final_samples=False,
                    scan_steps=False, compute_log_likelihood=True,
                    weight_clip=False):
    """Run ``n_steps`` of (M-)PMC with ``n_total`` fresh particles per step,
    fully sharded over the device mesh.

    Each step is ONE compiled ``shard_map`` computation: per-shard
    propose/evaluate/weight, then the PMC update with psum'ed sufficient
    statistics -- so every device ends each step with the identical adapted
    mixture.  This is the device-mesh form of the reference's MPI pipeline
    (``examples/pmc_mpi.py:85-131``).

    :param target: jittable log target density ``x -> log P(x)``.
    :param params: initial stacked mixture
        (:class:`~pypmc_tpu.density.core.MixtureParams`); Student-t iff
        ``params.dof`` is not None.
    :param n_total: total particles per step; rounded UP to the next
        multiple of the mesh size when not divisible (the reference's MPI
        sampler similarly takes a per-rank count, ``tools/parallel_sampler.py:35``).
    :param n_steps: number of PMC adaptation steps.

    :param weight_clip: clip the weights at ``global mean * sqrt(n)``
        for the ADAPTATION only (truncated importance sampling, Ionides
        2008; diagnostics and evidence stay unclipped) -- stabilizes
        updates when single weights dominate.  The weights are then clipped
        between the draw and the update (clipping needs the global weight
        mean first).
    :param scan_steps: if True, run ALL steps inside one compiled
        ``lax.scan`` (amortizes per-step dispatch latency; no per-step host
        visibility).  ``return_final_samples`` is not available in this mode.
    :param compute_log_likelihood: the [Cap+08] eq. (5) log-likelihood of
        the UPDATED mixture needs one extra evaluation pass over the
        samples per step; pass False to skip it (``stats.log_likelihood``
        is then NaN) when only the weight diagnostics matter.

    Returns ``(params, stats)`` with ``stats`` a :class:`PMCStepStats` of
    ``(n_steps,)`` arrays; with ``return_final_samples`` additionally the
    last step's sharded ``(samples_T (D, n_total), weights)``.
    """
    if mesh is None:
        mesh = particle_mesh()
    if key is None:
        key = jax.random.PRNGKey(0)
    n_dev = mesh.devices.size
    n_local = -(-int(n_total) // n_dev)   # ceil: any n_total is accepted
    if n_local * n_dev != n_total:
        logger.info(
            "n_total=%d is not divisible by %d devices; drawing %d per step",
            n_total, n_dev, n_local * n_dev)
    is_t = params.is_student_t

    # commit the initial mixture to the mesh-replicated sharding the step
    # itself produces -- otherwise the first step compiles for host-resident
    # inputs and the SECOND step (fed by the first's output) recompiles for
    # the mesh sharding, paying the remote XLA compile twice
    params = jax.device_put(
        params, jax.sharding.NamedSharding(mesh, P()))
    key = jax.device_put(key, jax.sharding.NamedSharding(mesh, P()))

    # the compiled step is cached across pmc_run_sharded calls (a fresh
    # closure per call would defeat jax.jit's cache and pay the XLA
    # compile on every invocation)
    token, tp, target_of = _target_token(target)
    if isinstance(target, _core.MixtureParams):
        # replicate target params onto the mesh like the mixture itself
        # (avoids a second compile for host-resident inputs)
        tp = jax.device_put(tp, jax.sharding.NamedSharding(mesh, P()))
    cache_key = (None if token is None else (
        "pmc_step", token, mesh, n_local, rb, dof_solver_steps,
        mindof, maxdof, axis_name, is_t, bool(scan_steps),
        n_steps if scan_steps else None, bool(compute_log_likelihood),
        bool(weight_clip)))

    # a MIXTURE target (MixtureParams) runs the per-shard step through
    # pmc_step_mixture_target; generic callables compose the
    # propose/evaluate step with the PMC update
    mixture_target = isinstance(target, _core.MixtureParams)

    def step_body(params, tp, key):
        """One PMC step on the local shard (called under shard_map)."""
        from ..mix_adapt.pmc import pmc_step_mixture_target

        my_key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        if mixture_target and rb and not weight_clip:
            result, samples_T, weights, latent, sw = pmc_step_mixture_target(
                params, target_of(tp), my_key, n_local,
                dof_solver_steps=dof_solver_steps if is_t else 0,
                mindof=mindof, maxdof=maxdof, axis_name=axis_name)
            sum_w, sum_w2, sum_wlogw = sw[0], sw[1], sw[2]
        else:
            samples_T, weights, latent = _is_body(params, my_key, n_local,
                                                  target_of(tp))
            sum_w = jax.lax.psum(jnp.sum(weights), axis_name)
            w_adapt = weights
            if weight_clip:
                # truncated-importance-sampling adaptation (Ionides 2008):
                # the UPDATE consumes weights clipped at the global
                # mean * sqrt(n_global); diagnostics/evidence stay unclipped
                n_global = float(n_local) * mesh.devices.size
                w_adapt = jnp.minimum(
                    weights,
                    (sum_w / n_global) * jnp.sqrt(jnp.asarray(
                        n_global, weights.dtype)))
            result = pmc_update(
                params, samples_T, w_adapt,
                # the non-Rao-Blackwellized update needs the generating
                # component indices (one-hot responsibilities)
                latent=None if rb else latent,
                rb=rb,
                dof_solver_steps=dof_solver_steps if is_t else 0,
                mindof=mindof, maxdof=maxdof,
                axis_name=axis_name,
                transposed=True,
            )
            sum_w2 = jax.lax.psum(jnp.sum(weights**2), axis_name)
            wlogw = jnp.where(weights > 0,
                              weights * jnp.log(jnp.where(weights > 0, weights, 1.0)),
                              0.0)
            sum_wlogw = jax.lax.psum(jnp.sum(wlogw), axis_name)
        # weight diagnostics (already psum-reduced, replicated result):
        # entropy of the normalized weights from the raw sums,
        # -sum wbar log wbar = log(sum w) - (sum w log w)/(sum w)
        n = jax.lax.psum(jnp.asarray(float(n_local), weights.dtype), axis_name)
        entr = jnp.log(sum_w) - sum_wlogw / sum_w
        perp = jnp.exp(entr) / n
        coeff_var = sum_w2 * n / sum_w**2 - 1.0
        ess = 1.0 / (1.0 + coeff_var)
        if compute_log_likelihood:
            norm_w = weights / sum_w
            loglik = pmc_log_likelihood(result.params, samples_T, norm_w,
                                        axis_name=axis_name, transposed=True)
        else:
            loglik = jnp.full((), jnp.nan, dtype=weights.dtype)
        stats = PMCStepStats(
            log_likelihood=loglik, perplexity=perp, ess=ess, evidence=sum_w / n
        )
        return result.params, stats, samples_T, weights

    if scan_steps:
        assert not return_final_samples, (
            "return_final_samples is not available with scan_steps=True"
        )

        run_all = _step_cache_get(cache_key)
        if run_all is None:
            @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P(), P()),
                     out_specs=(P(), P()), check_vma=False)
            def run_all(params, tp, keys):
                def body(carry, k):
                    new_params, stats, _, _ = step_body(carry, tp, k)
                    return new_params, stats

                return jax.lax.scan(body, params, keys)

            run_all = jax.jit(run_all)
            _step_cache_put(cache_key, run_all)

        keys = jax.random.split(key, n_steps)
        params, stats = run_all(params, tp, keys)
        return params, stats

    step = _step_cache_get(cache_key)
    if step is None:
        step = jax.jit(
            partial(
                jax.shard_map, mesh=mesh, in_specs=(P(), P(), P()),
                out_specs=(P(), P(), P(None, axis_name), P(axis_name)),
                check_vma=False,
            )(step_body)
        )
        _step_cache_put(cache_key, step)

    all_stats = []
    samples = weights = None
    for i in range(n_steps):
        key, sub = jax.random.split(key)
        params, stats, samples, weights = step(params, tp, sub)
        all_stats.append(stats)

    stats = PMCStepStats(*[jnp.stack([getattr(s, f) for s in all_stats])
                           for f in PMCStepStats._fields])
    if return_final_samples:
        return params, stats, samples, weights
    return params, stats


class ParallelSampler(object):
    """Data-parallel importance sampler over a device mesh -- the
    replacement for the reference's ``MPISampler``
    (``tools/parallel_sampler.py:7-80``).

    Unlike ``MPISampler`` there is no master rank: all devices participate
    in every run and the History on the host holds the *global* (already
    gathered) samples.  ``samples_list``/``weights_list`` provide the
    per-device view for compatibility with the reference's tests.

    :param target: jittable log target density.
    :param proposal: :class:`~pypmc_tpu.density.mixture.MixtureDensity`.
    :param mesh: a 1-D device mesh (default: all devices).
    :param indicator, prealloc, save_target_values, rng: as in
        :class:`~pypmc_tpu.sampler.importance_sampling.ImportanceSampler`.
    """

    def __init__(self, target, proposal, mesh=None, indicator=None,
                 prealloc=0, save_target_values=False, rng=None):
        self.mesh = mesh if mesh is not None else particle_mesh()
        self.n_devices = self.mesh.devices.size
        self.proposal = proposal
        self.target = _indmerge(target, indicator, -_np.inf)
        self.save_target_values = save_target_values
        self.target_values = _History(1, prealloc) if save_target_values else None
        self.weights = _History(1, prealloc)
        self.samples = _History(proposal.dim, prealloc)
        key = as_jax_key(rng)
        self._key = key if key is not None else jax.random.PRNGKey(0)
        # device-resident runs not yet flushed to the host Histories:
        # list of (samples_T (D, n) sharded, weights (n,) sharded)
        self._device_pending = []

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def run(self, N=1, trace_sort=False, to_host=True):
        """Draw ``N`` samples *per device* (total ``N * n_devices``,
        mirroring MPISampler's per-rank semantics,
        ``tools/parallel_sampler.py:35-58``).

        With ``to_host=True`` (default) the global samples and weights are
        copied into the host Histories, as MPISampler gathers to rank 0.
        With ``to_host=False`` they stay SHARDED ON DEVICE (accessible via
        :attr:`device_runs`; the O(N*D) device->host transfer -- ~400 MB/step
        at 10^7 particles in D=10 -- is deferred until :meth:`gather` or the
        next ``to_host=True`` run).  Device-side reductions
        (:meth:`evidence_stats`, the PMC/VB updates, ``combine_weights``)
        consume the sharded arrays directly, so a full adaptation loop never
        pays the transfer at all.

        Return the latent component indices if ``trace_sort``."""
        if N == 0:
            return 0
        n_total = int(N) * self.n_devices
        params = self.proposal.stacked_params()
        samples_T, weights, latent = run_is_step_sharded(
            params, self.target, self._next_key(), n_total, self.mesh
        )
        # keep the RUN-TIME params with the pending run: target_values must
        # be reconstructed with the proposal that drew the samples, even if
        # self.proposal is adapted before the deferred gather
        self._device_pending.append((samples_T, weights, params))
        if to_host:
            self.gather()
        if trace_sort:
            return latent if not to_host else self._to_host(latent)
        return None

    @property
    def device_runs(self):
        """Device-resident ``(samples_T, weights)`` tuples of the runs not
        yet flushed to the host Histories (``to_host=False`` runs)."""
        return [(s, w) for s, w, _ in self._device_pending]

    @staticmethod
    def _to_host(x):
        """Materialize a (possibly cross-process-sharded) array on this
        host.  Single process: a plain transfer.  Multi-process runtime:
        an all-gather, so EVERY process holds the global arrays -- the
        symmetric replacement for MPISampler's gather-to-rank-0."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            return _np.asarray(
                multihost_utils.process_allgather(x, tiled=True))
        return _np.asarray(x)

    def gather(self):
        """Flush all device-resident runs into the host Histories (the
        deferred MPISampler-gather).  Returns the number of runs flushed."""
        flushed = 0
        for samples_T, weights, run_params in self._device_pending:
            n = samples_T.shape[1]
            self.samples.append(n)[:] = self._to_host(samples_T).T
            w_host = self._to_host(weights)
            self.weights.append(n)[:, 0] = w_host
            if self.target_values is not None:
                log_q = self._to_host(
                    _core.mixture_logpdf_T(run_params, samples_T))
                with _np.errstate(divide="ignore"):
                    tv = _np.log(w_host) + log_q
                # a float32 weight that underflowed to exactly 0 loses the
                # finite log P it came from; recompute the target at those
                # few points so the stored values honor the "log P at
                # every visited point" contract (ImportanceSampler stores
                # the exact log P directly)
                bad = _np.flatnonzero(w_host == 0)
                if bad.size:
                    xs_bad = jnp.asarray(self.samples[-1][bad].T)
                    if isinstance(self.target, _core.MixtureParams):
                        tv[bad] = _np.asarray(
                            _core.mixture_logpdf_T(self.target, xs_bad))
                    else:
                        from ..sampler._target import evaluate_target_T

                        tv[bad] = _np.asarray(
                            evaluate_target_T(self.target, xs_bad))
                self.target_values.append(n)[:, 0] = tv
            flushed += 1
        self._device_pending = []
        return flushed

    def evidence_stats(self):
        """``(sum w, sum w^2, n)`` over ALL runs (host Histories plus
        device-resident ones), with the device terms reduced on device --
        only three scalars cross to the host.  Evidence = ``sum_w / n``,
        and perplexity/ESS follow from the same sums."""
        sum_w = float(self.weights[:][:, 0].sum()) if len(self.weights) else 0.0
        sum_w2 = float((self.weights[:][:, 0] ** 2).sum()) if len(self.weights) else 0.0
        n = self.weights[:].shape[0] if len(self.weights) else 0
        for _, w, _ in self._device_pending:
            sum_w += float(jnp.sum(w))
            sum_w2 += float(jnp.sum(w * w))
            n += int(w.shape[0])
        return sum_w, sum_w2, n

    @property
    def samples_list(self):
        """Per-device view of the last run's samples (MPISampler's
        ``samples_list`` analog).  Flushes any pending device-resident runs
        first, so "last run" always means the chronologically last one."""
        self.gather()
        return _np.array_split(self.samples[-1], self.n_devices)

    @property
    def weights_list(self):
        """Per-device view of the last run's weights (flushes pending
        device-resident runs first)."""
        self.gather()
        return _np.array_split(self.weights[-1], self.n_devices)

    def clear(self):
        """Clear the Histories AND drop any device-resident pending runs."""
        self.samples.clear()
        self.weights.clear()
        if self.target_values is not None:
            self.target_values.clear()
        self._device_pending = []
