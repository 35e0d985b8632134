"""Checkpoint / resume.

The reference has no serialization subsystem (state is picklable Python
objects); here every algorithm's state is an explicit pytree / set of arrays,
so checkpointing is first-class and dependency-light: plain ``.npz`` files
that survive process restarts, host moves and CPU<->GPU transitions.

* mixtures: :func:`save_mixture` / :func:`load_mixture` /
  :func:`load_mixture_params`
* variational Bayes: :func:`save_vb` / :func:`load_vb` (pairs with the
  ``posterior2prior`` warm-restart API, ``variational.pyx:211-231``)
* adaptive Markov chains: :func:`save_chain_state` / :func:`load_chain_state`
"""

import numpy as _np

__all__ = [
    "atomic_savez",
    "is_primary_process",
    "save_mixture",
    "load_mixture",
    "load_mixture_params",
    "save_vb",
    "load_vb",
    "save_chain_state",
    "load_chain_state",
]


def is_primary_process():
    """True unless this is a non-zero process of an initialized multi-process
    (``jax.distributed``) runtime.  Mirrors the host-0 log gating in
    :func:`pypmc_tpu.tools.util.log_to_stdout`: in a multi-process run every
    process executes the same host pipeline, so without gating every process
    would write the same checkpoint path concurrently."""
    try:
        import jax
    except Exception:
        return True
    # only consult the process topology if backends are already up --
    # asking earlier would force backend initialization at save time.  The
    # probe uses private API; if it ever disappears, fall back to ASKING
    # (which may initialize a backend) rather than silently disabling the
    # gating this function exists for.
    try:
        from jax._src import xla_bridge

        if not xla_bridge.backends_are_initialized():
            return True
    except Exception:
        pass
    try:
        return jax.process_count() <= 1 or jax.process_index() == 0
    except Exception:
        return True


def atomic_savez(path, **arrays):
    """Crash-safe ``np.savez``: write to a unique temp name, fsync, then
    atomically replace ``path``.  A process killed mid-save can therefore
    never leave a truncated archive behind -- a half-written checkpoint
    that exists but cannot be loaded would permanently break every
    subsequent resume.

    In a multi-process (``jax.distributed``) runtime only process 0
    writes (see :func:`is_primary_process`); on the other processes this
    is a no-op, exactly like sub-ERROR logging.  The temp name embeds the
    pid so that even two *independent* jobs pointed at the same path can
    never interleave into one temp file."""
    import os as _os

    if not is_primary_process():
        return
    # coerce before any file exists: a value that fails array conversion
    # would otherwise raise INSIDE np.savez, abandoning its internal ZipFile
    # unclosed over a file we then close (its __del__ later seeks the closed
    # handle -- an unraisable error at GC time)
    arrays = {k: _np.asarray(v) for k, v in arrays.items()}
    path = str(path)
    tmp = "%s.tmp.%d" % (path, _os.getpid())
    try:
        with open(tmp, "wb") as fh:
            _np.savez(fh, **arrays)
            fh.flush()
            _os.fsync(fh.fileno())
        _os.replace(tmp, path)
    except BaseException:
        try:
            _os.unlink(tmp)
        except OSError:
            pass
        raise


def save_mixture(path, mixture, extra=None):
    """Save a :class:`~pypmc_tpu.density.mixture.MixtureDensity` or stacked
    :class:`~pypmc_tpu.density.core.MixtureParams` to ``path`` (.npz,
    written atomically).  ``extra`` is an optional dict of additional
    arrays stored alongside (e.g. a config fingerprint); loaders ignore
    unknown fields."""
    from .density.core import MixtureParams

    if not isinstance(mixture, MixtureParams):
        mixture = mixture.stacked_params()
    arrays = dict(
        means=_np.asarray(mixture.means),
        cov=_np.asarray(mixture.cov),
        weights=_np.asarray(mixture.weights),
    )
    if mixture.dof is not None:
        arrays["dof"] = _np.asarray(mixture.dof)
    if extra:
        arrays.update({k: _np.asarray(v) for k, v in extra.items()})
    atomic_savez(path, **arrays)


def load_mixture_params(path):
    """Load stacked :class:`~pypmc_tpu.density.core.MixtureParams` (device
    arrays, derived quantities recomputed) from ``path``."""
    from .density import core

    with _np.load(path) as data:
        params, valid = core.make_mixture(
            data["means"], data["cov"], data["weights"],
            data["dof"] if "dof" in data else None,
        )
    return params


def load_mixture(path):
    """Load a host-side :class:`~pypmc_tpu.density.mixture.MixtureDensity`
    from ``path``."""
    from .density.mixture import MixtureDensity

    return MixtureDensity.from_params(load_mixture_params(path))


def save_vb(path, vb):
    """Save the full hyperparameter state (prior + posterior) of a
    :class:`~pypmc_tpu.mix_adapt.variational.GaussianInference`."""
    state = vb.prior_posterior()
    state = {k: _np.asarray(v) for k, v in state.items()}
    atomic_savez(path, **state)


def load_vb(path, data, weights=None, **kwargs):
    """Rebuild a :class:`~pypmc_tpu.mix_adapt.variational.GaussianInference`
    on ``data`` from a saved hyperparameter state; the first E-step is
    recomputed so the instance is immediately usable."""
    from .mix_adapt.variational import GaussianInference

    with _np.load(path) as f:
        state = {k: f[k] for k in f.files}
    components = int(state.pop("components"))
    posterior = {k: state.pop(k) for k in ("alpha", "beta", "nu", "m", "W")}
    vb = GaussianInference(
        data, components=components, weights=weights,
        alpha0=state["alpha0"], beta0=state["beta0"], nu0=state["nu0"],
        m0=state["m0"], W0=state["W0"],
        alpha=posterior["alpha"], beta=posterior["beta"], nu=posterior["nu"],
        m=posterior["m"], W=posterior["W"], **kwargs,
    )
    return vb


def save_chain_state(path, mc):
    """Save the adaptation-relevant state of an
    :class:`~pypmc_tpu.sampler.markov_chain.AdaptiveMarkovChain` (the sample
    History is intentionally excluded -- use :class:`~pypmc_tpu.tools.History`
    slicing + ``numpy.save`` for samples)."""
    atomic_savez(
        path,
        current_point=_np.asarray(mc.current_point),
        current_target_eval=_np.asarray(mc.current_target_eval),
        proposal_sigma=_np.asarray(mc.proposal.sigma),
        unscaled_sigma=_np.asarray(mc.unscaled_sigma),
        covar_scale_factor=_np.asarray(mc.covar_scale_factor),
        adapt_count=_np.asarray(mc.adapt_count),
    )


def load_chain_state(path, mc):
    """Restore state saved by :func:`save_chain_state` into an existing
    chain ``mc`` (constructed with the same target)."""
    with _np.load(path) as f:
        mc.current_point = f["current_point"].copy()
        mc.current_target_eval = float(f["current_target_eval"])
        mc.proposal.update(f["proposal_sigma"])
        mc.unscaled_sigma = f["unscaled_sigma"].copy()
        mc.covar_scale_factor = float(f["covar_scale_factor"])
        mc.adapt_count = int(f["adapt_count"])
    return mc
