"""Mixture probability densities.

API-parity re-design of the reference's ``pypmc/density/mixture.pyx``.  A
:class:`MixtureDensity` keeps a list of host-side component objects (for the
reference's object API) but all heavy evaluation/proposal work is dispatched
to the stacked-parameter batched computations in
:mod:`pypmc_tpu.density.core`.
"""

import numpy as _np
from copy import deepcopy as _deepcopy

from .base import ProbabilityDensity
from .gauss import Gauss
from .student_t import StudentT
from . import core as _core
from .._rng import RNG_DEFAULT, as_jax_key

__all__ = [
    "MixtureDensity",
    "create_gaussian_mixture",
    "recover_gaussian_mixture",
    "create_t_mixture",
    "recover_t_mixture",
]


def _host_logsumexp(a, weights):
    """Weighted max-shifted logsumexp on host numpy (``_regularize.pyx:19-55``)."""
    a = _np.asarray(a, dtype=float)
    max_val = _np.max(a)
    if not _np.isfinite(max_val):
        max_val = 0.0
    return _np.log(_np.sum(weights * _np.exp(a - max_val))) + max_val


class MixtureDensity(ProbabilityDensity):
    """Mixture probability density.  (Reference: ``density/mixture.pyx:21-212``.)

    :param components: Iterable of ProbabilityDensities; the mixture's
        components (deep-copied).
    :param weights: Iterable of floats; the component weights (normalized
        automatically during initialization).
    """

    def __init__(self, components, weights=None):
        self.components = [_deepcopy(component) for component in components]
        assert self.components, "a mixture needs at least one component"
        self.dim = self.components[0].dim
        _np.testing.assert_equal(
            [comp.dim for comp in self.components],
            [self.dim] * len(self.components),
        )
        if weights is None:
            self.weights = _np.ones(len(self.components))
        else:
            self.weights = _np.array(weights, dtype=float)
            assert len(self.weights) == len(self.components)
        self.normalize()

    # ------------------------------------------------------------------ #
    # stacked-parameter bridge to the functional core                     #
    # ------------------------------------------------------------------ #

    @property
    def kind(self):
        """'gauss' | 'student_t' | 'generic' -- selects the batched path."""
        if all(type(c) is Gauss or isinstance(c, Gauss) for c in self.components):
            return "gauss"
        if all(isinstance(c, StudentT) for c in self.components):
            return "student_t"
        return "generic"

    def stacked_params(self, dtype=None):
        """Stack the components into a :class:`pypmc_tpu.density.core.MixtureParams`
        pytree for batched device evaluation.  Only available for homogeneous
        Gauss or Student-t mixtures."""
        import jax.numpy as jnp

        kind = self.kind
        if kind == "generic":
            raise TypeError(
                "stacked_params requires a homogeneous Gauss or StudentT mixture"
            )
        if dtype is None:
            dtype = jnp.zeros(0).dtype  # jax default float dtype (f64 iff x64)
        means = jnp.asarray(_np.array([c.mu for c in self.components]), dtype=dtype)
        covs = jnp.asarray(_np.array([c.sigma for c in self.components]), dtype=dtype)
        weights = jnp.asarray(self.weights, dtype=dtype)
        dofs = None
        if kind == "student_t":
            dofs = jnp.asarray(_np.array([c.dof for c in self.components]), dtype=dtype)
        # components hold pre-validated covariances => reuse host cholesky etc.
        chol = jnp.asarray(
            _np.array([c._local_gauss.cholesky_sigma if kind == "gauss"
                       else c._local_t.cholesky_sigma for c in self.components]),
            dtype=dtype,
        )
        inv_sigma = jnp.asarray(_np.array([c.inv_sigma for c in self.components]), dtype=dtype)
        log_det = jnp.asarray(_np.array([c.log_det_sigma for c in self.components]), dtype=dtype)
        import jax.scipy.linalg as _jsl

        eye = jnp.broadcast_to(jnp.eye(self.dim, dtype=dtype), chol.shape)
        inv_chol = _jsl.solve_triangular(chol, eye, lower=True)
        return _core.MixtureParams(
            means=means,
            cov=covs,
            chol=chol,
            inv_chol=inv_chol,
            inv_sigma=inv_sigma,
            log_det=log_det,
            weights=weights / jnp.sum(weights),
            dof=dofs,
        )

    def evaluate_fn(self, batched=False):
        """Return a jittable callable closed over the CURRENT stacked
        parameters (a snapshot -- later updates to this mixture are not
        reflected).  Use this to hand a mixture to jitted samplers as the
        target density.

        With ``batched=False`` (default) the callable maps ``x (D,) ->
        log q(x)`` (the reference's ``evaluate`` contract).  With
        ``batched=True`` it maps the full block ``x (N, D) -> (N,)`` in one
        mixture evaluation and is marked as a batched target -- the fast
        path for the samplers (per-sample quadratic forms under ``vmap``
        lower to many tiny matmuls).
        """
        import jax.numpy as jnp

        params = self.stacked_params()

        if batched:
            from ..sampler._target import batched_target

            @batched_target(transposed=True)
            def log_q(xT):
                return _core.mixture_logpdf_T(params, jnp.asarray(xT))

            return log_q

        def log_q(x):
            return _core.mixture_logpdf(params, jnp.asarray(x)[None, :])[0]

        return log_q

    @classmethod
    def from_params(cls, params):
        """Build a :class:`MixtureDensity` from stacked
        :class:`~pypmc_tpu.density.core.MixtureParams` (device -> host sync)."""
        means = _np.asarray(params.means, dtype=float)
        covs = _np.asarray(params.cov, dtype=float)
        weights = _np.asarray(params.weights, dtype=float)
        if params.is_student_t:
            dofs = _np.asarray(params.dof, dtype=float)
            comps = [StudentT(m, c, d) for m, c, d in zip(means, covs, dofs)]
        else:
            comps = [Gauss(m, c) for m, c in zip(means, covs)]
        return cls(comps, weights)

    def set_params(self, params):
        """Overwrite this mixture's components/weights from stacked params
        (in-place device -> host sync)."""
        means = _np.asarray(params.means, dtype=float)
        covs = _np.asarray(params.cov, dtype=float)
        self.weights = _np.asarray(params.weights, dtype=float).copy()
        if params.is_student_t:
            dofs = _np.asarray(params.dof, dtype=float)
            for k, c in enumerate(self.components):
                c.update(means[k], covs[k], dofs[k])
        else:
            for k, c in enumerate(self.components):
                c.update(means[k], covs[k])

    # ------------------------------------------------------------------ #
    # reference API                                                      #
    # ------------------------------------------------------------------ #

    def __len__(self):
        number_of_components = len(self.components)
        assert number_of_components == len(self.weights)
        return number_of_components

    def normalize(self):
        """Rescale the component weights so they sum to 1."""
        self.weights /= self.weights.sum()

    def normalized(self):
        """are the component weights normalized?"""
        return _np.allclose(self.weights.sum(), 1.0)

    def prune(self, threshold=0.0):
        """Remove components with weight <= ``threshold``.  Return list of
        removed components as ``[(index, component, weight), ...]``."""
        removed_indices = []
        removed_components = []
        n = len(self.weights)
        for i, c in enumerate(reversed(self.components)):
            if self.weights[n - i - 1] <= threshold:
                current_index = n - i - 1
                removed_indices.append(current_index)
                removed_components.append(
                    (current_index, self.components.pop(current_index), self.weights[current_index])
                )
        self.weights = _np.delete(self.weights, removed_indices)
        return removed_components

    def evaluate(self, x, individual=False):
        """Evaluate ``log q(x)`` at a single point (weights assumed
        normalized).  If ``individual``, additionally return the per-component
        log-densities."""
        components_evaluated = _np.empty(len(self.components))
        for i, comp in enumerate(self.components):
            components_evaluated[i] = comp.evaluate(x)
        res = _host_logsumexp(components_evaluated, self.weights)
        if individual:
            return res, components_evaluated
        return res

    def multi_evaluate(self, x, out=None, individual=None, components=None):
        """Evaluate the density at all points in ``x``.

        Same contract as the reference (``mixture.pyx:112-156``): fills the
        ``(N, K)`` array ``individual`` with per-component log-densities if
        given; returns the ``(N,)`` mixture log-density (or None when a
        component subset is selected).  This is ONE batched device
        computation instead of per-component Cython loops.
        """
        x = _np.asarray(x)
        assert x.shape[1] == self.dim, (
            "points have dimension %i, mixture expects %i"
            % (x.shape[1], self.dim)
        )
        if individual is not None:
            assert individual.shape == (len(x), len(self)), (
                "individual output buffer must have shape %s for this x"
                % ((len(x), len(self)),)
            )

        if self.kind == "generic":
            return self._multi_evaluate_host(x, out, individual, components)

        params = self.stacked_params()
        logpdfs = _np.asarray(_core.component_logpdfs(params, x))

        if components is None:
            if individual is not None:
                individual[:] = logpdfs
            res = _np.asarray(_core.logsumexp(logpdfs, _np.asarray(params.weights), axis=-1))
            # stacked_params normalizes the weights; evaluate() (and the
            # reference) uses them AS STORED -- keep the two public APIs
            # consistent when a caller mutated self.weights without
            # normalize()
            w_sum = float(_np.sum(self.weights))
            if w_sum != 1.0:
                res = res + _np.log(w_sum)
            if out is None:
                return res
            assert len(out) == len(x), "out has the wrong length; expected %i" % len(x)
            out[:] = res
            return out
        else:
            assert out is None, "out cannot be combined with a components subset"
            assert individual is not None
            for k in components:
                individual[:, k] = logpdfs[:, k]
            return None

    def _multi_evaluate_host(self, x, out, individual, components):
        if individual is None:
            individual = _np.empty((len(x), len(self)))
        if components is None:
            for k, c in enumerate(self.components):
                c.multi_evaluate(x, individual[:, k])
            res = _np.array([_host_logsumexp(row, self.weights) for row in individual])
            if out is None:
                return res
            out[:] = res
            return out
        else:
            assert out is None, "out cannot be combined with a components subset"
            for k in components:
                self.components[k].multi_evaluate(x, individual[:, k])
            return None

    def propose(self, N=1, rng=RNG_DEFAULT, trace=False, shuffle=True):
        """Propose N points (weights assumed normalized).

        ``rng`` may be a numpy mtrand-style generator (reference-compatible
        multinomial block allocation, ``mixture.pyx:159-212``) or a jax PRNG
        key / int seed (device per-particle categorical draw -- already
        unordered, so ``shuffle`` is a no-op there).

        If ``trace``, additionally return the generating component index per
        sample.
        """
        if trace and shuffle:
            raise ValueError("shuffle and trace cannot both be requested")

        key = as_jax_key(rng) if rng is not RNG_DEFAULT else None
        if key is not None and self.kind != "generic":
            params = self.stacked_params()
            samples, latent = _core.propose(params, key, int(N))
            samples = _np.asarray(samples)
            if trace:
                return samples, _np.asarray(latent)
            return samples

        # numpy-rng host path (reference semantics)
        if rng is not RNG_DEFAULT and key is not None:
            # jax key but generic components: use a seeded numpy generator
            import jax

            rng = _np.random.RandomState(int(jax.random.randint(key, (), 0, 2**31 - 1)))
        to_get = rng.multinomial(N, self.weights)
        output_samples = _np.empty((N, self.dim))
        current_write_start = 0
        for i, comp in enumerate(self.components):
            if to_get[i] != 0:
                # decide the arity from the signature (the reference also
                # calls propose(n) for rng-less components, mixture.pyx:199);
                # catching TypeError instead would silently swallow genuine
                # TypeErrors INSIDE a component's propose and retry without
                # the user's rng -- irreproducible samples with no warning
                import inspect

                try:
                    n_args = len(inspect.signature(comp.propose).parameters)
                except (TypeError, ValueError):
                    n_args = 2
                if n_args >= 2:
                    block = comp.propose(to_get[i], rng)
                else:
                    block = comp.propose(to_get[i])
                output_samples[
                    current_write_start : current_write_start + to_get[i]
                ] = block
            current_write_start += to_get[i]

        if trace:
            output_origin = _np.repeat(_np.arange(len(self.components)), to_get)
            return output_samples, output_origin
        if shuffle:
            rng.shuffle(output_samples)
        return output_samples


def create_gaussian_mixture(means, covs, weights=None):
    """Create a :class:`MixtureDensity` with :class:`Gauss` components.
    (Reference: ``mixture.pyx:214-247``.)"""
    assert len(means) == len(covs), (
        "got %i means but %i covariance matrices"
        % (len(means), len(covs))
    )
    return MixtureDensity([Gauss(m, c) for m, c in zip(means, covs)], weights)


def recover_gaussian_mixture(mixture):
    """Extract ``(means, covs, weights)`` from a Gaussian
    :class:`MixtureDensity`.  (Reference: ``mixture.pyx:249-277``.)"""
    weights = _np.array(mixture.weights)
    means = _np.array([c.mu for c in mixture.components])
    covs = _np.array([c.sigma for c in mixture.components])
    return means, covs, weights


def create_t_mixture(means, covs, dofs, weights=None):
    """Create a :class:`MixtureDensity` with :class:`StudentT` components.
    (Reference: ``mixture.pyx:279-318``.)"""
    assert len(means) == len(covs) and len(means) == len(dofs), (
        "got %i means, %i covariances and %i dofs -- counts must agree"
        % (len(means), len(covs), len(dofs))
    )
    return MixtureDensity(
        [StudentT(m, c, d) for m, c, d in zip(means, covs, dofs)], weights
    )


def recover_t_mixture(mixture):
    """Extract ``(means, covs, dofs, weights)`` from a Student-t
    :class:`MixtureDensity`.  (Reference: ``mixture.pyx:320-350``.)"""
    weights = _np.array(mixture.weights)
    means = _np.array([c.mu for c in mixture.components])
    covs = _np.array([c.sigma for c in mixture.components])
    dofs = _np.array([c.dof for c in mixture.components])
    return means, covs, dofs, weights
