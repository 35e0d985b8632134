"""Tests for the PMC adaptation layer.

The exact-value tests compare against an independent numpy implementation of
the published update equations ([Cap+08] eq. 14, [HOD12] eq. 16) written out
below -- the reference package's test strategy of checking the sufficient
statistics on a small fixed sample table (SURVEY.md section 4, genre 1).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.special import digamma, gammaln
from scipy.optimize import brentq

from pypmc_tpu.density import create_gaussian_mixture, create_t_mixture
from pypmc_tpu.density import core
from pypmc_tpu.mix_adapt.pmc import (
    PMC,
    calculate_rho_rb,
    gaussian_pmc,
    pmc_log_likelihood,
    student_t_pmc,
)


# ------------------------------------------------------------------ #
# independent numpy model of the update equations                     #
# ------------------------------------------------------------------ #

def gauss_logpdf(x, mu, sigma):
    d = len(mu)
    diff = x - mu
    inv = np.linalg.inv(sigma)
    _, logdet = np.linalg.slogdet(sigma)
    return -0.5 * d * np.log(2 * np.pi) - 0.5 * logdet - 0.5 * diff @ inv @ diff


def t_logpdf(x, mu, sigma, dof):
    d = len(mu)
    diff = x - mu
    inv = np.linalg.inv(sigma)
    _, logdet = np.linalg.slogdet(sigma)
    maha = diff @ inv @ diff
    return (
        gammaln(0.5 * (dof + d)) - gammaln(0.5 * dof)
        - 0.5 * d * np.log(dof * np.pi) - 0.5 * logdet
        - 0.5 * (dof + d) * np.log(1 + maha / dof)
    )


def rho_rb_numpy(samples, means, covs, dofs, alpha):
    """Rao-Blackwellized responsibilities from first principles."""
    N, K = len(samples), len(means)
    q = np.empty((N, K))
    for k in range(K):
        for n in range(N):
            if dofs is None:
                q[n, k] = gauss_logpdf(samples[n], means[k], covs[k])
            else:
                q[n, k] = t_logpdf(samples[n], means[k], covs[k], dofs[k])
    lin = np.exp(q) * alpha[None, :]
    return lin / lin.sum(axis=1, keepdims=True)


def gaussian_pmc_numpy(samples, means, covs, alpha, weights):
    """[Cap+08] eq. (14) update, independent implementation."""
    rho = rho_rb_numpy(samples, means, covs, None, alpha)
    c = weights[:, None] * rho
    alpha_u = c.sum(axis=0)
    new_alpha = alpha_u / weights.sum()
    new_means = (c[:, :, None] * samples[:, None, :]).sum(axis=0) / alpha_u[:, None]
    new_covs = np.empty_like(covs)
    for k in range(len(means)):
        diff = samples - new_means[k]
        new_covs[k] = np.einsum("n,ni,nj->ij", c[:, k], diff, diff) / alpha_u[k]
    return new_alpha, new_means, new_covs


def student_t_pmc_numpy(samples, means, covs, dofs, alpha, weights,
                        mindof=1e-5, maxdof=1e3):
    """[Cap+08] eq. (14) + [HOD12] update for Student-t, independent
    implementation with scipy's brentq for the dof."""
    N, K = len(samples), len(means)
    d = samples.shape[1]
    rho = rho_rb_numpy(samples, means, covs, dofs, alpha)
    maha = np.empty((N, K))
    for k in range(K):
        inv = np.linalg.inv(covs[k])
        diff = samples - means[k]
        maha[:, k] = np.einsum("ni,ij,nj->n", diff, inv, diff)
    gamma = (dofs[None, :] + d) / (dofs[None, :] + maha)

    c = weights[:, None] * rho
    alpha_u = c.sum(axis=0)
    new_alpha = alpha_u / weights.sum()

    cg = c * gamma
    new_means = (cg[:, :, None] * samples[:, None, :]).sum(axis=0) / cg.sum(axis=0)[:, None]
    new_covs = np.empty_like(covs)
    for k in range(K):
        diff = samples - new_means[k]
        new_covs[k] = np.einsum("n,ni,nj->ij", cg[:, k], diff, diff) / alpha_u[k]

    # dof via [HOD12] eq. (16) first-order condition
    new_dofs = np.empty(K)
    for k in range(K):
        b = maha[:, k]
        nu = dofs[k]
        xi = rho[:, k] * (np.log(0.5 * (b + nu)) - digamma(0.5 * (d + nu))) + (
            1 - rho[:, k]
        ) * (np.log(0.5 * nu) - digamma(0.5 * nu))
        delta = rho[:, k] * (d + nu) / (b + nu) + (1 - rho[:, k])
        const = 1.0 - np.sum(weights * (xi + delta)) / weights.sum()
        f = lambda v: const + np.log(0.5 * v) - digamma(0.5 * v)
        if f(mindof) < 0:
            new_dofs[k] = mindof
        elif f(maxdof) > 0:
            new_dofs[k] = maxdof
        else:
            new_dofs[k] = brentq(f, mindof, maxdof, xtol=1e-13)
    return new_alpha, new_means, new_covs, new_dofs


# fixed sample table (20 samples, 2-D)
RNG = np.random.default_rng(2158)
SAMPLES = np.vstack(
    [RNG.normal([1.0, 1.0], 0.6, size=(12, 2)), RNG.normal([-2.0, 0.5], 0.8, size=(8, 2))]
)
WEIGHTS = np.abs(RNG.normal(1.0, 0.3, size=20))

MEANS0 = np.array([[0.5, 1.2], [-1.5, 0.0]])
COVS0 = np.array([[[0.6, 0.1], [0.1, 0.5]], [[0.9, -0.2], [-0.2, 0.7]]])
ALPHA0 = np.array([0.6, 0.4])
DOFS0 = np.array([4.0, 15.0])


class TestRho:
    def test_rho_rb_matches_numpy(self):
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        rho = np.asarray(calculate_rho_rb(mix.stacked_params(), jnp.asarray(SAMPLES)))
        expected = rho_rb_numpy(SAMPLES, MEANS0, COVS0, None, ALPHA0)
        assert np.allclose(rho, expected, atol=1e-12)

    def test_rho_dead_component_zero(self):
        mix = create_gaussian_mixture(MEANS0, COVS0, np.array([1.0, 0.0]))
        rho = np.asarray(calculate_rho_rb(mix.stacked_params(), jnp.asarray(SAMPLES)))
        assert np.all(rho[:, 1] == 0.0)
        assert np.allclose(rho[:, 0], 1.0)


class TestGaussianPMC:
    def test_exact_update_weighted(self):
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        out = gaussian_pmc(SAMPLES, mix, weights=WEIGHTS)
        ea, em, ec = gaussian_pmc_numpy(SAMPLES, MEANS0, COVS0, ALPHA0, WEIGHTS)
        assert np.allclose(out.weights, ea, atol=1e-10)
        for k in range(2):
            assert np.allclose(out.components[k].mu, em[k], atol=1e-10)
            assert np.allclose(out.components[k].sigma, ec[k], atol=1e-10)

    def test_exact_update_unweighted(self):
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        out = gaussian_pmc(SAMPLES, mix)
        ea, em, ec = gaussian_pmc_numpy(SAMPLES, MEANS0, COVS0, ALPHA0, np.ones(20))
        assert np.allclose(out.weights, ea, atol=1e-10)
        for k in range(2):
            assert np.allclose(out.components[k].mu, em[k], atol=1e-10)
            assert np.allclose(out.components[k].sigma, ec[k], atol=1e-10)

    def test_copy_semantics(self):
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        out = gaussian_pmc(SAMPLES, mix, weights=WEIGHTS, copy=True)
        assert np.allclose(mix.components[0].mu, MEANS0[0])  # untouched
        assert not np.allclose(out.components[0].mu, MEANS0[0])
        out2 = gaussian_pmc(SAMPLES, mix, weights=WEIGHTS, copy=False)
        assert out2 is mix
        assert np.allclose(mix.components[0].mu, out.components[0].mu)

    def test_latent_non_rb(self):
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        latent = np.array([0] * 12 + [1] * 8)
        out = gaussian_pmc(SAMPLES, mix, latent=latent, rb=False)
        # one-hot responsibilities: each component is fit to its own samples
        for k, sel in enumerate([slice(0, 12), slice(12, 20)]):
            sub = SAMPLES[sel]
            assert np.allclose(out.components[k].mu, sub.mean(axis=0), atol=1e-10)
            diff = sub - sub.mean(axis=0)
            cov = np.einsum("ni,nj->ij", diff, diff) / len(sub)
            assert np.allclose(out.components[k].sigma, cov, atol=1e-10)
        assert np.allclose(out.weights, [12 / 20, 8 / 20])

    def test_mincount_kills_component(self):
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        latent = np.array([0] * 18 + [1] * 2)
        out = gaussian_pmc(SAMPLES, mix, latent=latent, rb=True, mincount=5)
        assert out.weights[1] == 0.0
        assert np.isclose(out.weights.sum(), 1.0)
        # killed component keeps its old parameters
        assert np.allclose(out.components[1].mu, MEANS0[1])
        assert np.allclose(out.components[1].sigma, COVS0[1])

    def test_mincount_requires_latent(self):
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        with pytest.raises(ValueError):
            gaussian_pmc(SAMPLES, mix, mincount=5)
        with pytest.raises(ValueError):
            gaussian_pmc(SAMPLES, mix, rb=False)

    def test_singular_update_sets_weight_zero(self):
        # component 1 gets a single sample (non-rb) -> zero covariance ->
        # invalid -> weight 0 and old parameters kept
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        latent = np.array([0] * 19 + [1])
        out = gaussian_pmc(SAMPLES, mix, latent=latent, rb=False)
        assert out.weights[1] == 0.0
        assert np.allclose(out.components[1].mu, MEANS0[1])
        assert np.allclose(out.components[1].sigma, COVS0[1])
        assert np.isclose(out.weights.sum(), 1.0)


class TestStudentTPMC:
    def test_exact_update_weighted(self):
        mix = create_t_mixture(MEANS0, COVS0, DOFS0, ALPHA0)
        out = student_t_pmc(SAMPLES, mix, weights=WEIGHTS)
        ea, em, ec, ed = student_t_pmc_numpy(
            SAMPLES, MEANS0, COVS0, DOFS0, ALPHA0, WEIGHTS
        )
        assert np.allclose(out.weights, ea, atol=1e-10)
        for k in range(2):
            assert np.allclose(out.components[k].mu, em[k], atol=1e-10)
            assert np.allclose(out.components[k].sigma, ec[k], atol=1e-10)
            assert np.isclose(out.components[k].dof, ed[k], atol=1e-6)

    def test_exact_update_unweighted(self):
        mix = create_t_mixture(MEANS0, COVS0, DOFS0, ALPHA0)
        out = student_t_pmc(SAMPLES, mix)
        ea, em, ec, ed = student_t_pmc_numpy(
            SAMPLES, MEANS0, COVS0, DOFS0, ALPHA0, np.ones(20)
        )
        assert np.allclose(out.weights, ea, atol=1e-10)
        for k in range(2):
            assert np.allclose(out.components[k].mu, em[k], atol=1e-10)
            assert np.allclose(out.components[k].sigma, ec[k], atol=1e-10)
            assert np.isclose(out.components[k].dof, ed[k], atol=1e-6)

    def test_dof_update_disabled(self):
        mix = create_t_mixture(MEANS0, COVS0, DOFS0, ALPHA0)
        out = student_t_pmc(SAMPLES, mix, dof_solver_steps=0)
        for k in range(2):
            assert out.components[k].dof == DOFS0[k]


class TestPMCDriver:
    def test_log_likelihood(self):
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        pmc = PMC(SAMPLES, mix, weights=WEIGHTS)
        expected = 0.0
        wn = WEIGHTS / WEIGHTS.sum()
        for n in range(len(SAMPLES)):
            q = np.log(
                sum(
                    ALPHA0[k] * np.exp(gauss_logpdf(SAMPLES[n], MEANS0[k], COVS0[k]))
                    for k in range(2)
                )
            )
            expected += wn[n] * q
        assert np.isclose(pmc.log_likelihood(), expected, atol=1e-10)

    def test_run_converges_and_improves(self):
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        pmc = PMC(SAMPLES, mix, weights=WEIGHTS)
        initial = pmc.log_likelihood()
        converged_at = pmc.run(iterations=200, rel_tol=1e-12)
        assert converged_at is not None
        assert pmc.log_likelihood() >= initial

    def test_type_validation(self):
        with pytest.raises(TypeError):
            PMC(SAMPLES, "not a mixture")

    def test_run_terminates_under_bound_oscillation(self, monkeypatch):
        """float32 arithmetic can make the log-likelihood oscillate at the
        last few ulps instead of increasing monotonically; the convergence
        loop must neither hang nor declare convergence on a decrease step."""
        mix = create_gaussian_mixture(MEANS0, COVS0, ALPHA0)
        pmc = PMC(SAMPLES, mix, weights=WEIGHTS)
        calls = {"n": 0}

        def oscillating_bound():
            calls["n"] += 1
            return -1.0 + (1e-6 if calls["n"] % 2 == 0 else -1e-6)

        monkeypatch.setattr(pmc, "log_likelihood", oscillating_bound)
        monkeypatch.setattr(pmc, "_update_once", lambda: None)
        # strict alternation never satisfies increase-within-tol at tight
        # tolerances: the loop must exhaust its iterations and return None
        assert pmc.run(iterations=30, rel_tol=1e-12, abs_tol=1e-15) is None
        # with a loose tolerance it converges -- and only on an INCREASE step
        calls["n"] = 0
        it = pmc.run(iterations=30, rel_tol=1e-3)
        assert it is not None
        # the step it converged on saw bound > old_bound (even call index)
        assert calls["n"] % 2 == 0

    def test_end_to_end_bimodal_recovery(self):
        """Full IS+PMC loop on the reference's flagship workload
        (examples/pmc.py): bimodal 2-D Gaussian target with weights
        0.3/0.7; PMC must recover component weights, means, covariances."""
        target_means = [np.array([-5.0, 0.0]), np.array([5.0, 0.0])]
        target_covs = [np.array([[0.9, 0.0], [0.0, 0.9]]),
                       np.array([[0.8, 0.2], [0.2, 0.8]])]
        target_weights = np.array([0.3, 0.7])
        target_mix = create_gaussian_mixture(target_means, target_covs, target_weights)
        target_params = target_mix.stacked_params()

        def log_target(x):
            return core.mixture_logpdf(target_params, x[None, :])[0]

        # deliberately poor initial proposal
        prop = create_gaussian_mixture(
            [np.array([-4.0, 2.0]), np.array([4.0, -2.0]), np.array([0.0, 0.0])],
            [np.eye(2) * 3] * 3,
        )
        key = jax.random.PRNGKey(42)
        for step in range(12):
            key, sub = jax.random.split(key)
            params = prop.stacked_params()
            samples, latent = core.propose(params, sub, 2000)
            log_q = core.mixture_logpdf(params, samples)
            log_p = jax.vmap(log_target)(samples)
            w = np.asarray(jnp.exp(log_p - log_q))
            prop = gaussian_pmc(np.asarray(samples), prop, weights=w, copy=False)

        # the adapted proposal recovers the target within MC error
        live = np.flatnonzero(prop.weights > 0.05)
        assert len(live) == 2
        recovered = sorted(
            [(prop.weights[k], prop.components[k]) for k in live],
            key=lambda t: t[0],
        )
        assert np.isclose(recovered[0][0], 0.3, atol=0.05)
        assert np.isclose(recovered[1][0], 0.7, atol=0.05)
        assert np.allclose(recovered[0][1].mu, target_means[0], atol=0.15)
        assert np.allclose(recovered[1][1].mu, target_means[1], atol=0.15)
        assert np.allclose(recovered[0][1].sigma, target_covs[0], atol=0.3)
        assert np.allclose(recovered[1][1].sigma, target_covs[1], atol=0.3)


class TestDofSolverEdgeCases:
    def test_root_below_mindof_clamps(self):
        """Force the first-order condition's root below mindof: the dof is
        clamped to mindof (reference ValueError branch, pmc.pyx:700-710)."""
        mix = create_t_mixture(MEANS0, COVS0, DOFS0, ALPHA0)
        out = student_t_pmc(SAMPLES, mix, weights=WEIGHTS, mindof=900.0, maxdof=1000.0)
        # the true roots for this data are ~O(1..100) < 900 -> clamp to mindof
        ea, em, ec, ed = student_t_pmc_numpy(
            SAMPLES, MEANS0, COVS0, DOFS0, ALPHA0, WEIGHTS, mindof=900.0, maxdof=1000.0
        )
        for k in range(2):
            assert np.isclose(out.components[k].dof, ed[k], atol=1e-6)

    def test_interval_brackets_match_scipy(self):
        """Different bracket: results still match the scipy-brentq model."""
        mix = create_t_mixture(MEANS0, COVS0, DOFS0, ALPHA0)
        out = student_t_pmc(SAMPLES, mix, weights=WEIGHTS, mindof=0.5, maxdof=50.0)
        ea, em, ec, ed = student_t_pmc_numpy(
            SAMPLES, MEANS0, COVS0, DOFS0, ALPHA0, WEIGHTS, mindof=0.5, maxdof=50.0
        )
        for k in range(2):
            assert np.isclose(out.components[k].dof, ed[k], atol=1e-6)


class TestStudentTPMCDriver:
    def test_t_run_improves(self):
        # NOTE: the Student-t dof update is not guaranteed to increase the
        # [Cap+08] bound monotonically, so (like the reference) we assert
        # improvement rather than formal convergence at tight tolerance
        mix = create_t_mixture(MEANS0, COVS0, DOFS0, ALPHA0)
        pmc = PMC(SAMPLES, mix, weights=WEIGHTS)
        initial = pmc.log_likelihood()
        pmc.run(iterations=50, rel_tol=1e-6)
        assert pmc.log_likelihood() >= initial
        # dofs moved and stayed inside the default bracket
        dofs = np.array([c.dof for c in pmc.density.components])
        assert np.all(dofs >= 1e-5) and np.all(dofs <= 1e3)

    def test_t_end_to_end_is_pmc(self):
        """IS + Student-t PMC adapts a 3-component t-proposal to a bimodal
        Gaussian target (the reference's t-kernel use case)."""
        target_means = [np.array([-4.0, 0.0]), np.array([4.0, 0.0])]
        target_covs = [np.eye(2) * 0.5, np.eye(2) * 0.7]
        target_weights = np.array([0.4, 0.6])
        target_mix = create_gaussian_mixture(target_means, target_covs, target_weights)
        target_params = target_mix.stacked_params()

        def log_target(x):
            return core.mixture_logpdf(target_params, x[None, :])[0]

        prop = create_t_mixture(
            [np.array([-3.0, 1.0]), np.array([3.0, -1.0]), np.array([0.0, 0.0])],
            [np.eye(2) * 3] * 3, [5.0] * 3,
        )
        key = jax.random.PRNGKey(7)
        from pypmc_tpu.mix_adapt import student_t_pmc as t_pmc

        for step in range(10):
            key, sub = jax.random.split(key)
            params = prop.stacked_params()
            samples, latent = core.propose(params, sub, 2000)
            log_q = core.mixture_logpdf(params, samples)
            log_p = jax.vmap(log_target)(samples)
            w = np.asarray(jnp.exp(log_p - log_q))
            prop = t_pmc(np.asarray(samples), prop, weights=w, copy=False)

        live = np.flatnonzero(prop.weights > 0.05)
        assert len(live) == 2
        recovered = sorted((prop.weights[k], prop.components[k]) for k in live)
        assert np.isclose(recovered[0][0], 0.4, atol=0.07)
        assert np.isclose(recovered[1][0], 0.6, atol=0.07)
        assert np.allclose(recovered[0][1].mu, target_means[0], atol=0.2)
        assert np.allclose(recovered[1][1].mu, target_means[1], atol=0.2)
