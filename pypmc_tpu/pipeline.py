"""One-call evidence estimation: the full adaptive-importance-sampling
pipeline as a library function.

The reference ships this workflow only as an example script
(``examples/uniting_markov_chains_and_variational_bayes.py``); here it is a
first-class API, with the high-dimension practice baked into the defaults
(see ``docs/user_guide.md`` "High dimensions"):

    adaptive-MCMC chain pool -> Gelman-Rubin grouping (one long patch per
    group) -> variational Bayes -> inflated first IS run -> weighted-VB
    refinement -> Student-t M-PMC refinement -> final IS run ->
    deterministic-mixture combination.

Every stage runs on the device as jitted computations; mixture log-densities
go through the fused GPU kernel where :func:`pypmc_tpu.ops.mixture_kernel.use_kernel`
chooses it.  The PMC refinement defaults to the clipped-weight adaptation
(robustness matters more than one pass over the samples for a 10-step
stage); ``pmc_weight_clip=False`` selects
:func:`~pypmc_tpu.mix_adapt.pmc.pmc_step_mixture_target` instead.
"""

import time
from typing import NamedTuple, Optional

import numpy as _np

import logging

logger = logging.getLogger(__name__)

__all__ = ["integrate", "IntegrateResult"]


class IntegrateResult(NamedTuple):
    """Result of :func:`integrate`."""

    evidence: float                # integral estimate of exp(log_target)
    uncertainty: float             # Monte-Carlo standard error
    perplexity: float              # normalized perplexity of the weights
    ess: float                     # normalized effective sample size
    proposal: object               # final adapted MixtureDensity (Student-t)
    n_samples: int                 # combined sample count
    samples: object                # (N, D) combined IS samples
    weights: object                # (N,) combined deterministic-mixture weights
    details: dict                  # per-stage diagnostics and wall times


def integrate(target, dim, starts, *, key=None, mesh=None, n_chains=None,
              checkpoint_dir=None,
              mcmc_steps=400, mcmc_cycles=12, thin=5, K_g=1,
              critical_r=2.0, inflate=2.0, pmc_steps=10, pmc_dof=8.0,
              pmc_weight_clip=True, return_samples=True,
              n_is1=1 << 17, n_is2=1 << 19, vb_iterations=300,
              rel_tol=1e-8, abs_tol=1e-5, verbose=False):
    r"""Estimate :math:`Z = \int e^{\log P(x)}\,dx` for a multimodal target
    with (almost) no analytical knowledge, via the full adaptive pipeline.

    :param target: the log target density -- a jittable callable
        ``x (D,) -> log P(x)``, or a
        :class:`~pypmc_tpu.density.mixture.MixtureDensity` /
        :class:`~pypmc_tpu.density.core.MixtureParams` (mixture targets are
        evaluated by the mixture log-density, batched over the particles).
    :param dim: dimension D.
    :param starts: ``(C, D)`` Markov-chain starting points covering the
        region of interest (e.g. prior draws); the target must be finite at
        every start.
    :param key: jax PRNG key (default: seed 0).
    :param checkpoint_dir: optional directory for stage checkpoints
        (plain ``.npz``).  Each completed stage (MCMC prerun, first VB fit,
        refined proposal) is saved; a re-run with the same directory
        resumes from the furthest completed stage (a run resumed from the
        refined proposal redoes only the final sampling stage and
        estimates from it alone).  In a multi-process (``jax.distributed``)
        run only process 0 writes (see
        :func:`~pypmc_tpu.checkpoint.is_primary_process`); the directory
        must be a path every process can read (shared filesystem), since
        the per-stage resume decisions have to agree across processes.
    :param mesh: optional 1-D ``jax.sharding.Mesh``; both IS runs shard
        their particle axis over it (:class:`~pypmc_tpu.parallel.ParallelSampler`),
        the VB E-steps run per-shard with psum'ed statistics, and the PMC
        refinement is :func:`~pypmc_tpu.parallel.pmc_run_sharded` -- the
        identical pipeline scales to a multi-host slice.
    :param n_chains: use only the first ``n_chains`` rows of ``starts``.
    :param mcmc_steps, mcmc_cycles: adaptive-Metropolis schedule
        ([HST01]); total chain length is their product, half is burn-in.
    :param thin: thinning of the pooled MCMC samples fed to VB.
    :param K_g: long patches per chain group.  Keep 1 for D >= 20
        (narrow-component mode tiling biases the evidence low).
    :param critical_r: Gelman-Rubin grouping threshold.
    :param inflate: first-run proposal covariance inflation (insurance
        against under-equilibrated chains; the weighted refinements then
        recover the true moments from reweighted samples).
    :param pmc_steps, pmc_dof: Student-t M-PMC refinement schedule; 0
        steps disables the stage.
    :param pmc_weight_clip: clip the importance weights at
        ``mean(w) * sqrt(n)`` for the ADAPTATION only (truncated importance
        sampling, Ionides 2008) -- stabilizes the refinement when the
        initial proposal's tail mismatch makes single weights dominate
        (heavy-tailed targets at high D); the evidence estimate itself
        always uses unclipped weights.
    :param n_is1, n_is2: particle counts of the two IS runs.
    :param vb_iterations, rel_tol, abs_tol: VB convergence controls.
    :param return_samples: with False, the combined IS samples are NOT
        materialized on the host (``result.samples`` is None).  On the
        single-device path an evidence-only run then never pays the final
        O(N*D) device->host transfer; under ``mesh=`` the runs are
        host-gathered either way (the sharded combination requires it)
        and only the final copy into ``result.samples`` is skipped.
    :returns: :class:`IntegrateResult`.
    """
    import jax
    import numpy as np

    from . import density as _density
    from . import mix_adapt as _mix_adapt
    from . import sampler as _sampler
    from . import tools as _tools
    from .density import core as _core
    from .mix_adapt.pmc import pmc_step_mixture_target

    say = logger.info if not verbose else (lambda *a: print(a[0] % tuple(a[1:])))
    t_all = time.perf_counter()
    if key is None:
        key = jax.random.PRNGKey(0)

    # normalize the target forms: mcmc_target feeds the chain pool,
    # log_target feeds IS
    target_params = None
    if isinstance(target, _density.MixtureDensity):
        target_params = target.stacked_params()
        log_target = target.evaluate_fn(batched=True)
    elif isinstance(target, _core.MixtureParams):
        target_params = target
        from .sampler._target import batched_target

        @batched_target(transposed=True)
        def log_target(xT, _tp=target_params):
            return _core.mixture_logpdf_T(_tp, xT)
    else:
        log_target = target
    mcmc_target = target_params if target_params is not None else log_target

    starts = np.asarray(starts)
    if n_chains is not None:
        starts = starts[:n_chains]
    if starts.ndim != 2 or starts.shape[1] != dim:
        raise ValueError("starts must be (n_chains, %d), got %s"
                         % (dim, starts.shape))
    if target_params is not None:
        starts = starts.astype(np.asarray(target_params.means).dtype)

    details = {}

    # stage checkpoints (plain npz; see the checkpoint module)
    import os as _os

    from . import checkpoint as _checkpoint

    def _ck(name):
        return (_os.path.join(checkpoint_dir, name)
                if checkpoint_dir is not None else None)

    def _have(name):
        return checkpoint_dir is not None and _os.path.exists(_ck(name))

    _atomic_savez = _checkpoint.atomic_savez

    # resuming under different kwargs would apply the CURRENT schedule to
    # stale state (e.g. a changed mcmc_steps slices the loaded pool into
    # an empty burn-in) -- fingerprint every knob that shapes the
    # checkpointed state and reject mismatches
    config_fp = np.array([dim, len(starts), mcmc_steps, mcmc_cycles,
                          thin, K_g, critical_r, inflate, pmc_dof,
                          vb_iterations, rel_tol, abs_tol],
                         dtype=np.float64)

    def _check_fp(data, path):
        fp = data.get("config_fp")
        if fp is None or not np.array_equal(fp, config_fp):
            raise ValueError(
                "checkpoint %s was written under a different pipeline "
                "configuration (saved %s, current %s); delete the "
                "checkpoint directory or rerun with the original settings"
                % (path, None if fp is None else fp.tolist(),
                   config_fp.tolist()))

    if checkpoint_dir is not None:
        _os.makedirs(checkpoint_dir, exist_ok=True)
    resumed = []

    vbmix = prior = None
    final_mix = None
    if _have("refined_mixture.npz"):
        with np.load(_ck("refined_mixture.npz")) as data:
            _check_fp(data, _ck("refined_mixture.npz"))
        final_mix = _checkpoint.load_mixture(_ck("refined_mixture.npz"))
        resumed = ["mcmc", "vb1", "refined"]
        say("resuming from refined proposal (K=%d)", len(final_mix))
    elif _have("vb1.npz"):
        with np.load(_ck("vb1.npz"), allow_pickle=False) as data:
            _check_fp(data, _ck("vb1.npz"))
            prior = {k[6:]: data[k] for k in data.files
                     if k.startswith("prior_")}
        vbmix = _checkpoint.load_mixture(_ck("vb1_mixture.npz"))
        resumed = ["mcmc", "vb1"]
        say("resuming from VB1 fit (K=%d)", len(vbmix))

    if final_mix is None and vbmix is None:
        # ---- 1. adaptive-MCMC chain pool
        t0 = time.perf_counter()
        key, sub = jax.random.split(key)
        if _have("mcmc.npz"):
            with np.load(_ck("mcmc.npz")) as data:
                _check_fp(data, _ck("mcmc.npz"))
                pool, rates = data["pool"], data["rates"]
            resumed = ["mcmc"]
            say("resuming from MCMC prerun (%d chains)", len(pool))
        else:
            pool, rates = _sampler.sample_adaptive_chains(
                mcmc_target, starts, np.eye(dim) * 2.38 ** 2 / dim,
                n_steps=mcmc_steps, n_adapt_cycles=mcmc_cycles, key=sub)
            pool = np.asarray(pool)
            if checkpoint_dir is not None:
                _atomic_savez(_ck("mcmc.npz"), pool=pool,
                              rates=np.asarray(rates),
                              config_fp=config_fp)
        burn = mcmc_steps * mcmc_cycles // 2
        chains = [c[burn:] for c in pool]
        details["mcmc_s"] = time.perf_counter() - t0
        details["accept_rates"] = np.asarray(rates)[:, -1]
        say("MCMC: %d chains x %d steps (%.1f s)",
            len(starts), mcmc_steps * mcmc_cycles, details["mcmc_s"])

        # ---- 2. Gelman-Rubin grouping -> long-patches mixture
        long_patches = _mix_adapt.make_r_gaussmix(
            chains, K_g=K_g, critical_r=critical_r)
        details["patches_K"] = len(long_patches)

        # ---- 3. variational Bayes on the thinned pooled samples
        t0 = time.perf_counter()
        mc_samples = np.vstack(chains)[::thin]
        vb = _mix_adapt.GaussianInference(
            mc_samples, initial_guess=long_patches, W0=np.eye(dim) * 1e10,
            mesh=mesh)
        # never let a component fall below D+1 members: its scatter would be
        # singular and the precision overflows float32 (measured at D=20)
        vb.run(vb_iterations, rel_tol=rel_tol, abs_tol=abs_tol,
               prune=max(0.5 * vb.N / vb.K, dim + 1.0))
        vbmix = vb.make_mixture()
        prior = vb.posterior2prior()
        prior.pop("alpha0")
        details["vb1_s"] = time.perf_counter() - t0
        details["vb1_K"] = len(vbmix)
        say("VB1: %d samples -> K=%d (%.1f s)",
            len(mc_samples), len(vbmix), details["vb1_s"])
        if checkpoint_dir is not None:
            _checkpoint.save_mixture(_ck("vb1_mixture.npz"), vbmix)
            _atomic_savez(_ck("vb1.npz"), config_fp=config_fp,
                          **{"prior_" + k: np.asarray(v)
                             for k, v in prior.items()})

    run1_proposal = None
    if final_mix is None:
        # ---- 4. inflated first IS run + weighted-VB refinement
        mi, ci, wi = _density.recover_gaussian_mixture(vbmix)
        vbmix_wide = _density.create_gaussian_mixture(mi, inflate * ci, wi)
        key, sub = jax.random.split(key)
        if mesh is not None:
            from . import parallel as _parallel

            n_dev = mesh.devices.size
            sampler = _parallel.ParallelSampler(
                log_target, vbmix_wide, mesh=mesh, rng=sub)
        else:
            n_dev = 1
            sampler = _sampler.ImportanceSampler(log_target, vbmix_wide, rng=sub)
        t0 = time.perf_counter()
        # single-device path: keep the run ON DEVICE -- VB2 and the final
        # combination consume the device arrays directly, so the pipeline
        # never pays the O(N*D) host round-trip
        device_resident = mesh is None
        sampler.run(-(-n_is1 // n_dev), to_host=not device_resident)
        if device_resident and sampler.device_runs:
            import jax.numpy as jnp

            sT1, w1 = sampler.device_runs[0]
            # the host path's GaussianInference validation would catch
            # this; keep the same loud failure for device arrays (a f32
            # overflow w = exp(log p - log q) = inf would otherwise
            # NaN-poison VB2)
            if not bool(jnp.isfinite(jnp.sum(w1))):
                raise ValueError(
                    "importance weights contain inf/nan (float32 overflow "
                    "in exp(log p - log q)?)")
            vb2_data, vb2_w = sT1.T, w1
        else:
            device_resident = False
            vb2_data, vb2_w = sampler.samples[:], sampler.weights[:][:, 0]
        vb2 = _mix_adapt.GaussianInference(
            vb2_data, initial_guess=vbmix, weights=vb2_w, mesh=mesh, **prior)
        vb2.run(vb_iterations, rel_tol=rel_tol, abs_tol=abs_tol)
        vb2mix = vb2.make_mixture()
        details["is1_vb2_s"] = time.perf_counter() - t0
        details["vb2_K"] = len(vb2mix)

        # ---- 5. Student-t M-PMC refinement (heavy tails + importance-weighted
        # EM against the target itself; redundant components die)
        t0 = time.perf_counter()
        m2, c2, w2 = _density.recover_gaussian_mixture(vb2mix)
        pmc_mix = _density.create_t_mixture(
            m2, c2 * (pmc_dof - 2.0) / pmc_dof, np.full(len(w2), pmc_dof), w2)
        if pmc_steps > 0 and mesh is not None:
            # sharded refinement: each step is one shard_map computation with
            # psum'ed statistics (works for mixture AND callable targets)
            from .parallel import pmc_run_sharded

            key, sub = jax.random.split(key)
            pparams, stats = pmc_run_sharded(
                mcmc_target, pmc_mix.stacked_params(), n_is1, pmc_steps,
                mesh=mesh, key=sub, weight_clip=pmc_weight_clip)
            live = np.asarray(pparams.weights) > 0
            if live.any():
                final_mix = _density.create_t_mixture(
                    np.asarray(pparams.means)[live],
                    np.asarray(pparams.cov)[live],
                    np.asarray(pparams.dof)[live],
                    np.asarray(pparams.weights)[live])
            else:
                # fully degenerate refinement (all components died --
                # can happen when the IS weights are extremely skewed at
                # high D): keep the un-refined heavy-tailed proposal
                logger.warning(
                    "PMC refinement killed every component; keeping the "
                    "pre-refinement proposal")
                final_mix = pmc_mix
            details["pmc_perplexity_curve"] = [
                float(x) for x in np.asarray(stats.perplexity)]
        elif pmc_steps > 0 and target_params is not None:
            import jax.numpy as jnp
            from .mix_adapt.pmc import pmc_update

            pparams = pmc_mix.stacked_params()
            perp_curve = []
            for _ in range(pmc_steps):
                key, sub = jax.random.split(key)
                if pmc_weight_clip:
                    # propose+eval as one jitted step; the update runs
                    # on weights truncated at mean*sqrt(n) (Ionides 2008)
                    # so a lone tail spike cannot starve the statistics
                    out = _core.propose_logq_T(
                        pparams, sub, n_is1, target_params)
                    samples_T, _, log_q, log_p = out
                    w = jnp.exp(log_p - log_q)
                    w_adapt = jnp.minimum(
                        w, jnp.mean(w) * jnp.sqrt(float(n_is1)))
                    result = pmc_update(
                        pparams, samples_T, w_adapt, transposed=True,
                        dof_solver_steps=100)
                    sw = np.asarray(jnp.stack([
                        jnp.sum(w), jnp.sum(w * w),
                        jnp.sum(jnp.where(
                            w > 0,
                            w * jnp.log(jnp.maximum(w, 1e-38)), 0.0)),
                    ]))  # ONE host materialization per step
                else:
                    result, _, _, _, sw = pmc_step_mixture_target(
                        pparams, target_params, sub, n_is1)
                    sw = np.asarray(sw)
                if not bool(np.asarray(result.params.weights > 0).any()):
                    # a step that kills every component cannot be used;
                    # keep the last live parameters and stop refining
                    logger.warning(
                        "PMC refinement step killed every component; "
                        "stopping at the last live proposal")
                    break
                pparams = result.params
                perp_curve.append(float(
                    np.exp(-(sw[2] / sw[0]) + np.log(sw[0])) / n_is1))
            live = np.asarray(pparams.weights) > 0
            final_mix = _density.create_t_mixture(
                np.asarray(pparams.means)[live], np.asarray(pparams.cov)[live],
                np.asarray(pparams.dof)[live], np.asarray(pparams.weights)[live])
            details["pmc_perplexity_curve"] = perp_curve
        elif pmc_steps > 0:
            # generic callable target: PMC from stored IS samples via the
            # reference-protocol driver (same Ionides-2008 clipping for
            # the adaptation when requested)
            key, sub = jax.random.split(key)
            s2 = _sampler.ImportanceSampler(log_target, pmc_mix, rng=sub)
            for _ in range(pmc_steps):
                s2.run(n_is1)
                w_run = s2.weights[-1][:, 0]
                if pmc_weight_clip:
                    w_run = np.minimum(
                        w_run, w_run.mean() * np.sqrt(float(len(w_run))))
                pmc = _mix_adapt.PMC(s2.samples[-1], s2.proposal,
                                     weights=w_run)
                pmc.run(1)
                s2.proposal = pmc.density
            final_mix = s2.proposal
        else:
            final_mix = pmc_mix
        details["pmc_s"] = time.perf_counter() - t0
        details["final_K"] = len(final_mix)
        say("PMC refinement: K=%d live (%.1f s)",
            len(final_mix), details["pmc_s"])
        run1_proposal = vbmix_wide
        if checkpoint_dir is not None:
            _checkpoint.save_mixture(_ck("refined_mixture.npz"), final_mix,
                                     extra={"config_fp": config_fp})
    else:
        # resumed from the refined proposal: only the final
        # sampling stage runs; the estimate uses that run alone
        key, sub = jax.random.split(key)
        if mesh is not None:
            from . import parallel as _parallel

            n_dev = mesh.devices.size
            sampler = _parallel.ParallelSampler(
                log_target, final_mix, mesh=mesh, rng=sub)
        else:
            n_dev = 1
            sampler = _sampler.ImportanceSampler(
                log_target, final_mix, rng=sub)
        device_resident = mesh is None
        details["final_K"] = len(final_mix)

    # ---- 6. final IS run, deterministic-mixture combination, estimate
    t0 = time.perf_counter()
    sampler.proposal = final_mix
    sampler.run(-(-n_is2 // n_dev), to_host=not device_resident)
    proposals = ([run1_proposal, final_mix] if run1_proposal is not None
                 else [final_mix])
    if device_resident and len(sampler.device_runs) == len(proposals):
        runs = sampler.device_runs
        weights = _sampler.combine_weights(
            [sT.T for sT, _ in runs], [w for _, w in runs],
            proposals)[:][:, 0]
    else:
        sampler.gather()
        weights = _sampler.combine_weights(
            [sampler.samples[i] for i in range(len(proposals))],
            [sampler.weights[i][:, 0] for i in range(len(proposals))],
            proposals,
        )[:][:, 0]
    details["is2_combine_s"] = time.perf_counter() - t0
    details["resumed_stages"] = resumed
    if return_samples:
        sampler.gather()
        samples = sampler.samples[:]
    else:
        samples = None

    evidence = weights.sum() / len(weights)
    uncertainty = _np.sqrt(
        (weights ** 2).sum() / len(weights) - evidence ** 2
    ) / _np.sqrt(len(weights) - 1)
    details["total_s"] = time.perf_counter() - t_all
    return IntegrateResult(
        evidence=float(evidence),
        uncertainty=float(uncertainty),
        perplexity=float(_tools.perp(weights)),
        ess=float(_tools.ess(weights)),
        proposal=final_mix,
        n_samples=int(len(weights)),
        samples=samples,
        weights=weights,
        details=details,
    )
