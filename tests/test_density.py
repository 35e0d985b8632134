"""Tests for the density layer: component classes, stacked mixtures, and
the batched functional core (values checked against closed-form formulas)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.special import gammaln

from pypmc_tpu.density import (
    Gauss,
    LocalGauss,
    LocalStudentT,
    MixtureDensity,
    StudentT,
    create_gaussian_mixture,
    create_t_mixture,
    recover_gaussian_mixture,
    recover_t_mixture,
)
from pypmc_tpu.density import core


# ------------------------------------------------------------------ #
# reference formulas                                                  #
# ------------------------------------------------------------------ #

def gauss_logpdf_ref(x, mu, sigma):
    d = len(mu)
    diff = x - mu
    inv = np.linalg.inv(sigma)
    _, logdet = np.linalg.slogdet(sigma)
    return -0.5 * d * np.log(2 * np.pi) - 0.5 * logdet - 0.5 * diff @ inv @ diff


def t_logpdf_ref(x, mu, sigma, dof):
    d = len(mu)
    diff = x - mu
    inv = np.linalg.inv(sigma)
    _, logdet = np.linalg.slogdet(sigma)
    maha = diff @ inv @ diff
    return (
        gammaln(0.5 * (dof + d))
        - gammaln(0.5 * dof)
        - 0.5 * d * np.log(dof * np.pi)
        - 0.5 * logdet
        - 0.5 * (dof + d) * np.log(1 + maha / dof)
    )


MU = np.array([1.0, -1.0])
SIGMA = np.array([[1.3, 0.7], [0.7, 1.5]])
DOF = 5.0
POINTS = [np.array([0.0, 0.0]), np.array([1.3, -0.5]), np.array([-4.0, 2.2])]


# ------------------------------------------------------------------ #
# component classes                                                   #
# ------------------------------------------------------------------ #

class TestGauss:
    def test_evaluate(self):
        g = Gauss(MU, SIGMA)
        for x in POINTS:
            assert np.isclose(g.evaluate(x), gauss_logpdf_ref(x, MU, SIGMA))

    def test_multi_evaluate(self):
        g = Gauss(MU, SIGMA)
        x = np.array(POINTS)
        expected = [gauss_logpdf_ref(p, MU, SIGMA) for p in POINTS]
        assert np.allclose(g.multi_evaluate(x), expected)

    def test_invalid_sigma_keeps_old_state(self):
        g = Gauss(MU, SIGMA)
        asymmetric = np.array([[1.0, 0.5], [0.3, 1.0]])
        with pytest.raises(np.linalg.LinAlgError):
            g.update(np.zeros(2), asymmetric)
        assert np.allclose(g.mu, MU)
        assert np.allclose(g.sigma, SIGMA)
        # still evaluates correctly
        assert np.isclose(g.evaluate(POINTS[0]), gauss_logpdf_ref(POINTS[0], MU, SIGMA))

    def test_not_positive_definite_raises(self):
        with pytest.raises(np.linalg.LinAlgError):
            Gauss(MU, np.array([[1.0, 2.0], [2.0, 1.0]]))

    def test_propose_moments(self):
        g = Gauss(MU, SIGMA)
        samples = g.propose(200000, np.random.RandomState(12345))
        assert np.allclose(np.mean(samples, axis=0), MU, atol=0.02)
        assert np.allclose(np.cov(samples, rowvar=0), SIGMA, atol=0.03)

    def test_propose_jax_key(self):
        g = Gauss(MU, SIGMA)
        samples = g.propose(200000, jax.random.PRNGKey(1))
        assert np.allclose(np.mean(samples, axis=0), MU, atol=0.02)
        assert np.allclose(np.cov(samples, rowvar=0), SIGMA, atol=0.03)


class TestStudentT:
    def test_evaluate(self):
        t = StudentT(MU, SIGMA, DOF)
        for x in POINTS:
            assert np.isclose(t.evaluate(x), t_logpdf_ref(x, MU, SIGMA, DOF))

    def test_multi_evaluate(self):
        t = StudentT(MU, SIGMA, DOF)
        x = np.array(POINTS)
        expected = [t_logpdf_ref(p, MU, SIGMA, DOF) for p in POINTS]
        assert np.allclose(t.multi_evaluate(x), expected)

    def test_invalid_update_keeps_state(self):
        t = StudentT(MU, SIGMA, DOF)
        with pytest.raises(np.linalg.LinAlgError):
            t.update(np.zeros(2), np.array([[1.0, 2.0], [2.0, 1.0]]), 3.0)
        assert t.dof == DOF
        assert np.allclose(t.sigma, SIGMA)

    def test_propose_moments(self):
        t = StudentT(MU, SIGMA, DOF)
        samples = t.propose(400000, np.random.RandomState(5))
        assert np.allclose(np.mean(samples, axis=0), MU, atol=0.02)
        # cov of t = dof/(dof-2) sigma
        assert np.allclose(
            np.cov(samples, rowvar=0), DOF / (DOF - 2.0) * SIGMA, atol=0.1
        )

    def test_dof_positive_required(self):
        with pytest.raises(AssertionError):
            LocalStudentT(SIGMA, -1.0)


class TestLocalGauss:
    def test_evaluate_symmetric(self):
        lg = LocalGauss(SIGMA)
        x, y = POINTS[0], POINTS[1]
        assert np.isclose(lg.evaluate(x, y), gauss_logpdf_ref(x, y, SIGMA))
        assert np.isclose(lg.evaluate(x, y), lg.evaluate(y, x))
        assert lg.symmetric


# ------------------------------------------------------------------ #
# stacked functional core                                             #
# ------------------------------------------------------------------ #

MEANS = np.array([[1.0, -1.0], [2.0, 3.0], [-3.0, 0.5]])
COVS = np.array(
    [
        [[1.3, 0.7], [0.7, 1.5]],
        [[0.5, 0.0], [0.0, 0.5]],
        [[2.0, -0.4], [-0.4, 1.0]],
    ]
)
WEIGHTS = np.array([0.5, 0.3, 0.2])
DOFS = np.array([3.0, 10.0, 55.0])


class TestCore:
    def test_gauss_component_logpdfs(self):
        params, valid = core.make_mixture(MEANS, COVS, WEIGHTS)
        assert np.all(np.asarray(valid))
        x = np.array(POINTS)
        out = np.asarray(core.component_logpdfs(params, x))
        for k in range(3):
            expected = [gauss_logpdf_ref(p, MEANS[k], COVS[k]) for p in POINTS]
            assert np.allclose(out[:, k], expected)

    def test_t_component_logpdfs(self):
        params, valid = core.make_mixture(MEANS, COVS, WEIGHTS, DOFS)
        x = np.array(POINTS)
        out = np.asarray(core.component_logpdfs(params, x))
        for k in range(3):
            expected = [t_logpdf_ref(p, MEANS[k], COVS[k], DOFS[k]) for p in POINTS]
            assert np.allclose(out[:, k], expected)

    def test_mixture_logpdf(self):
        params, _ = core.make_mixture(MEANS, COVS, WEIGHTS)
        x = np.array(POINTS)
        out = np.asarray(core.mixture_logpdf(params, x))
        for i, p in enumerate(POINTS):
            lin = sum(
                WEIGHTS[k] * np.exp(gauss_logpdf_ref(p, MEANS[k], COVS[k]))
                for k in range(3)
            )
            assert np.isclose(out[i], np.log(lin))

    def test_propose_abundances_and_moments(self):
        params, _ = core.make_mixture(MEANS, COVS, WEIGHTS)
        n = 300000
        samples, latent = core.propose(params, jax.random.PRNGKey(0), n)
        samples, latent = np.asarray(samples), np.asarray(latent)
        counts = np.bincount(latent, minlength=3) / n
        assert np.allclose(counts, WEIGHTS, atol=0.005)
        for k in range(3):
            sel = samples[latent == k]
            assert np.allclose(sel.mean(axis=0), MEANS[k], atol=0.03)
            assert np.allclose(np.cov(sel, rowvar=0), COVS[k], atol=0.05)

    def test_propose_student_t_moments(self):
        params, _ = core.make_mixture(MEANS, COVS, WEIGHTS, DOFS)
        n = 400000
        samples, latent = core.propose(params, jax.random.PRNGKey(3), n)
        samples, latent = np.asarray(samples), np.asarray(latent)
        for k in range(3):
            sel = samples[latent == k]
            assert np.allclose(sel.mean(axis=0), MEANS[k], atol=0.05)
            expected_cov = DOFS[k] / (DOFS[k] - 2.0) * COVS[k]
            assert np.allclose(np.cov(sel, rowvar=0), expected_cov, rtol=0.12, atol=0.06)

    def test_propose_fallback_matches_dense_gather(self):
        """The XLA fallback of ``propose_T`` gathers (D, K) Cholesky-column
        panels instead of an (N, D, D) table, which would be D times the
        size of the samples.  Pin it against the dense-gather formulation on
        the same draws."""
        params, _ = core.make_mixture(MEANS, COVS, WEIGHTS, DOFS)
        n = 4096
        samples_T, latent = core.propose_T(params, jax.random.PRNGKey(11), n)
        samples_T, latent = np.asarray(samples_T), np.asarray(latent)
        # reconstruct z and scale exactly as propose_T derives them
        k_cat, k_norm, k_chi = jax.random.split(jax.random.PRNGKey(11), 3)
        dtype = params.means.dtype
        zT = np.asarray(jax.random.normal(k_norm, (params.dim, n), dtype=dtype))
        dof_n = np.asarray(params.dof)[latent]
        chi2 = np.asarray(jax.random.chisquare(k_chi, dof_n, shape=(n,),
                                               dtype=dtype))
        scale = np.sqrt(dof_n / chi2)
        chol = np.asarray(params.chol)
        expected = (np.asarray(params.means)[latent]
                    + np.einsum("nij,jn->ni", chol[latent], zT)
                    * scale[:, None]).T
        assert np.allclose(samples_T, expected, atol=1e-10)

    def test_dead_component_never_drawn(self):
        w = np.array([0.5, 0.0, 0.5])
        params, _ = core.make_mixture(MEANS, COVS, w)
        _, latent = core.propose(params, jax.random.PRNGKey(7), 10000)
        assert not np.any(np.asarray(latent) == 1)

    def test_update_masked_invalid_keeps_old(self):
        params, _ = core.make_mixture(MEANS, COVS, WEIGHTS)
        new_means = MEANS + 1.0
        new_covs = COVS.copy()
        new_covs[1] = np.array([[1.0, 5.0], [5.0, 1.0]])  # not PD
        new_params, ok = core.update_masked(
            params, jnp.asarray(new_means), jnp.asarray(new_covs),
            jnp.asarray(WEIGHTS),
        )
        ok = np.asarray(ok)
        assert list(ok) == [True, False, True]
        out_w = np.asarray(new_params.weights)
        # component 1 died -> weight 0, others renormalized
        assert out_w[1] == 0.0
        assert np.isclose(out_w.sum(), 1.0)
        assert np.allclose(np.asarray(new_params.means)[1], MEANS[1])
        assert np.allclose(np.asarray(new_params.means)[0], new_means[0])


# ------------------------------------------------------------------ #
# MixtureDensity API                                                  #
# ------------------------------------------------------------------ #

class TestMixtureDensity:
    def make(self):
        return create_gaussian_mixture(MEANS, COVS, WEIGHTS)

    def test_create_recover_roundtrip(self):
        mix = self.make()
        m, c, w = recover_gaussian_mixture(mix)
        assert np.allclose(m, MEANS)
        assert np.allclose(c, COVS)
        assert np.allclose(w, WEIGHTS)

    def test_t_roundtrip(self):
        mix = create_t_mixture(MEANS, COVS, DOFS, WEIGHTS)
        m, c, d, w = recover_t_mixture(mix)
        assert np.allclose(m, MEANS)
        assert np.allclose(d, DOFS)

    def test_weight_normalization(self):
        mix = MixtureDensity([Gauss(MU, SIGMA)] * 2, [4.0, 12.0])
        assert np.allclose(mix.weights, [0.25, 0.75])
        assert mix.normalized()

    def test_evaluate_matches_core(self):
        mix = self.make()
        params = mix.stacked_params()
        for p in POINTS:
            assert np.isclose(
                mix.evaluate(p), float(core.mixture_logpdf(params, p[None, :])[0])
            )

    def test_multi_evaluate_individual(self):
        mix = self.make()
        x = np.array(POINTS)
        individual = np.empty((len(x), 3))
        out = mix.multi_evaluate(x, individual=individual)
        for k in range(3):
            expected = [gauss_logpdf_ref(p, MEANS[k], COVS[k]) for p in POINTS]
            assert np.allclose(individual[:, k], expected)
        assert np.allclose(out, [mix.evaluate(p) for p in POINTS])

    def test_multi_evaluate_component_subset(self):
        mix = self.make()
        x = np.array(POINTS)
        individual = np.zeros((len(x), 3))
        res = mix.multi_evaluate(x, individual=individual, components=[1])
        assert res is None
        assert np.allclose(individual[:, 0], 0.0)  # untouched
        expected = [gauss_logpdf_ref(p, MEANS[1], COVS[1]) for p in POINTS]
        assert np.allclose(individual[:, 1], expected)

    def test_prune(self):
        mix = MixtureDensity(
            [Gauss(MEANS[k], COVS[k]) for k in range(3)], [0.5, 0.0, 0.5]
        )
        removed = mix.prune()
        assert len(removed) == 1
        assert removed[0][0] == 1
        assert len(mix) == 2

    def test_propose_trace_shuffle_conflict(self):
        mix = self.make()
        with pytest.raises(ValueError):
            mix.propose(10, trace=True, shuffle=True)

    def test_propose_numpy_rng(self):
        mix = self.make()
        rng = np.random.RandomState(2)
        samples, origin = mix.propose(50000, rng, trace=True, shuffle=False)
        counts = np.bincount(origin, minlength=3) / 50000
        assert np.allclose(counts, WEIGHTS, atol=0.01)

    def test_dim_mismatch_raises(self):
        with pytest.raises(AssertionError):
            MixtureDensity([Gauss(MU, SIGMA), Gauss(np.zeros(3), np.eye(3))])
