"""Tests for the Markov-chain samplers (scan kernel + adaptation)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pypmc_tpu.density import LocalGauss, LocalStudentT
from pypmc_tpu.sampler.markov_chain import (
    AdaptiveMarkovChain,
    MarkovChain,
    sample_adaptive_chains,
)
from pypmc_tpu.tools.indicator import hyperrectangle


MU = np.array([1.0, 2.0])
SIGMA = np.array([[1.0, 0.8], [0.8, 1.2]])
INV_SIGMA = np.linalg.inv(SIGMA)


def log_target(x):
    diff = x - jnp.asarray(MU)
    return -0.5 * diff @ jnp.asarray(INV_SIGMA) @ diff


class TestMarkovChain:
    def test_invalid_start_raises(self):
        prop = LocalGauss(np.eye(2) * 0.1)
        with pytest.raises(ValueError):
            MarkovChain(log_target, prop, np.array([np.nan, 0.0]))

    def test_basic_sampling_moments(self):
        prop = LocalGauss(np.eye(2) * 2.0)
        mc = MarkovChain(log_target, prop, MU.copy(), rng=11)
        accepted = mc.run(60000)
        assert 0 < accepted < 60000
        samples = mc.samples[:][5000:]  # discard burn-in
        assert np.allclose(samples.mean(axis=0), MU, atol=0.15)
        assert np.allclose(np.cov(samples, rowvar=0), SIGMA, atol=0.25)

    def test_student_t_proposal(self):
        prop = LocalStudentT(np.eye(2) * 2.0, dof=5.0)
        mc = MarkovChain(log_target, prop, MU.copy(), rng=13)
        mc.run(40000)
        samples = mc.samples[:][5000:]
        assert np.allclose(samples.mean(axis=0), MU, atol=0.15)

    def test_run_zero(self):
        prop = LocalGauss(np.eye(2))
        mc = MarkovChain(log_target, prop, MU.copy(), rng=0)
        assert mc.run(0) == 0

    def test_indicator_restricts_support(self):
        lower = MU - 1.0
        upper = MU + 1.0
        ind = hyperrectangle(lower, upper)
        prop = LocalGauss(np.eye(2) * 0.5)
        mc = MarkovChain(log_target, prop, MU.copy(), indicator=ind, rng=2)
        mc.run(5000)
        samples = mc.samples[:]
        assert np.all(samples >= lower - 1e-12)
        assert np.all(samples <= upper + 1e-12)

    def test_save_target_values(self):
        prop = LocalGauss(np.eye(2))
        mc = MarkovChain(log_target, prop, MU.copy(), rng=4, save_target_values=True)
        mc.run(100)
        tv = mc.target_values[:][:, 0]
        samples = mc.samples[:]
        expected = [float(log_target(jnp.asarray(s))) for s in samples]
        assert np.allclose(tv, expected)

    def test_nan_target_raises(self):
        def bad_target(x):
            # NaN outside a tiny box
            return jnp.where(jnp.all(jnp.abs(x - jnp.asarray(MU)) < 1e-3),
                             0.0, jnp.nan)

        prop = LocalGauss(np.eye(2))
        mc = MarkovChain(bad_target, prop, MU.copy(), rng=1)
        with pytest.raises(ValueError):
            mc.run(100)
        # continue_on_NaN rejects instead
        mc2 = MarkovChain(bad_target, prop, MU.copy(), rng=1)
        mc2.run(100, continue_on_NaN=True)
        assert np.allclose(mc2.samples[:], MU, atol=1e-3)

    def test_chain_continuity(self):
        prop = LocalGauss(np.eye(2))
        mc = MarkovChain(log_target, prop, MU.copy(), rng=9)
        mc.run(50)
        last = mc.samples[-1][-1]
        assert np.allclose(last, mc.current_point)

    def test_host_fallback_generic_proposal(self):
        class NumpyLocalGauss(LocalGauss):
            pass

        prop = LocalGauss(np.eye(2))
        mc = MarkovChain(log_target, prop, MU.copy(), rng=np.random.RandomState(3))
        accepted = mc.run(3000)
        assert 0 < accepted < 3000
        samples = mc.samples[:]
        assert np.allclose(samples[500:].mean(axis=0), MU, atol=0.4)


class TestAdaptiveMarkovChain:
    def test_adapt_improves_acceptance(self):
        prop = LocalGauss(np.eye(2) * 20.0)  # far too wide
        mc = AdaptiveMarkovChain(log_target, prop, MU.copy(), rng=21)
        rates = []
        for _ in range(12):
            accepted = mc.run(1000)
            rates.append(accepted / 1000)
            mc.adapt()
        # acceptance rate forced into (or towards) [0.15, 0.35]
        assert 0.1 < rates[-1] < 0.5
        # adapted covariance approximates the scaled target covariance
        assert np.allclose(
            mc.unscaled_sigma / np.abs(mc.unscaled_sigma).max(),
            SIGMA / np.abs(SIGMA).max(),
            atol=0.35,
        )

    def test_set_adapt_params_validation(self):
        prop = LocalGauss(np.eye(2))
        mc = AdaptiveMarkovChain(log_target, prop, MU.copy(), rng=0)
        mc.set_adapt_params(damping=0.6, force_acceptance_max=0.4)
        assert mc.damping == 0.6
        assert mc.force_acceptance_max == 0.4
        with pytest.raises(TypeError):
            mc.set_adapt_params(0.5)
        with pytest.raises(TypeError):
            mc.set_adapt_params(bogus=1)

    def test_covar_scale_factor_default(self):
        prop = LocalGauss(np.eye(2))
        mc = AdaptiveMarkovChain(log_target, prop, MU.copy(), rng=0)
        assert np.isclose(mc.covar_scale_factor, 2.38**2 / 2)


class TestVmappedChains:
    def test_parallel_chains_moments(self):
        starts = np.array([MU + d for d in [[0, 0], [1, -1], [-1, 1], [0.5, 0.5]]])
        samples, rates = sample_adaptive_chains(
            log_target, starts, np.eye(2) * 2.0, n_steps=2000, n_adapt_cycles=8,
            key=jax.random.PRNGKey(0),
        )
        samples = np.asarray(samples)
        assert samples.shape == (4, 16000, 2)
        pooled = samples[:, 4000:, :].reshape(-1, 2)
        assert np.allclose(pooled.mean(axis=0), MU, atol=0.15)
        assert np.allclose(np.cov(pooled, rowvar=0), SIGMA, atol=0.3)
        # final acceptance in a sane band after adaptation
        assert np.all(np.asarray(rates)[:, -1] > 0.05)


class TestAdaptFallback:
    def test_degenerate_run_falls_back_to_shrink(self):
        """All-identical samples give a zero covariance estimate; the full
        and diagonal updates both fail and the proposal covariance is
        divided by covar_scale_multiplier (reference fallback chain,
        markov_chain.py:378-391)."""
        prop = LocalGauss(np.eye(2))
        mc = AdaptiveMarkovChain(log_target, prop, MU.copy(), rng=0)
        sigma_before = mc.proposal.sigma.copy()
        # forge a degenerate last run: every visited point identical
        run = mc.samples.append(100)
        run[:] = MU
        mc._last_accept_count = 0
        # make the damped estimate exactly singular
        mc.unscaled_sigma = np.zeros((2, 2))
        mc.damping = 0.0  # a_t = 1 -> new estimate = sample cov = 0
        mc.adapt()
        assert np.allclose(
            mc.proposal.sigma, sigma_before / mc.covar_scale_multiplier
        )

    def test_scale_factor_bounds(self):
        prop = LocalGauss(np.eye(2))
        mc = AdaptiveMarkovChain(
            log_target, prop, MU.copy(), rng=0,
            covar_scale_factor=1.0, covar_scale_factor_max=2.0,
            covar_scale_factor_min=0.5, covar_scale_multiplier=10.0,
        )
        mc._update_scale_factor(accept_rate=1.0)   # would overshoot max
        assert mc.covar_scale_factor == 10.0       # one multiply allowed
        mc._update_scale_factor(accept_rate=1.0)   # now above max: frozen
        assert mc.covar_scale_factor == 10.0
        mc.covar_scale_factor = 1.0
        mc._update_scale_factor(accept_rate=0.0)
        assert mc.covar_scale_factor == 0.1
        mc._update_scale_factor(accept_rate=0.0)   # below min: frozen
        assert mc.covar_scale_factor == 0.1


def test_pool_mixture_target_cpu_path():
    """``sample_adaptive_chains`` accepts a ``MixtureParams`` target (run
    through the scan pool via the mixture's logpdf) and recovers the target
    moments."""
    from pypmc_tpu.density import core

    rng = np.random.default_rng(5)
    params, valid = core.make_mixture(
        MU[None, :].astype(np.float32),
        SIGMA[None].astype(np.float32),
    )
    assert bool(np.asarray(valid).all())
    C = 48
    starts = (MU[None, :] + rng.normal(0, 0.5, size=(C, 2))).astype(np.float32)
    samples, rates = sample_adaptive_chains(
        params, starts, np.eye(2, dtype=np.float32) * 2.38**2 / 2,
        n_steps=400, n_adapt_cycles=3, key=jax.random.PRNGKey(4))
    assert samples.shape == (C, 1200, 2)
    assert rates.shape == (C, 3)
    kept = np.asarray(samples[:, 400:, :]).reshape(-1, 2)
    assert np.allclose(kept.mean(axis=0), MU, atol=0.15)
    assert np.allclose(np.cov(kept, rowvar=False), SIGMA, atol=0.3)


# ------------------------------------------------------------------ #
# the chain pool: carried state, NaN policy, indicator, D=40          #
# ------------------------------------------------------------------ #

def bimodal_target(D=2):
    from pypmc_tpu.density import core

    tm = np.zeros((2, D), np.float32)
    tm[1] += 4.0
    tc = np.array([np.eye(D) * 0.5] * 2, np.float32)
    tparams, valid = core.make_mixture(tm, tc, np.array([0.5, 0.5], np.float32))
    assert bool(np.asarray(valid).all())
    return tparams


def test_pool_carries_state_across_cycles():
    """Each cycle continues from where the last one stopped: the step across
    a cycle boundary is an ordinary Metropolis step, far shorter than the
    distance the chains have wandered from their starts (a restart would
    jump back to them)."""
    tparams = bimodal_target(2)
    rng = np.random.default_rng(3)
    starts = rng.normal(2, 1, (130, 2)).astype(np.float32)
    s, r = sample_adaptive_chains(
        tparams, starts, np.eye(2, dtype=np.float32) * 0.5, 50, 3,
        key=jax.random.PRNGKey(0))
    s = np.asarray(s)
    assert s.shape == (130, 150, 2)
    steps = np.linalg.norm(np.diff(s, axis=1), axis=-1)     # (C, 149)
    for b in (49, 99):                                       # cycle boundaries
        assert steps[:, b].max() <= steps[:, b + 1:b + 50].max() + 1e-6
    wandered = np.linalg.norm(s[:, 49] - starts, axis=-1).mean()
    assert steps[:, 49].mean() < 0.5 * wandered
    assert np.isfinite(np.asarray(r)).all()


def test_pool_deterministic_per_key():
    tparams = bimodal_target(2)
    starts = np.zeros((16, 2), np.float32)
    sig = np.eye(2, dtype=np.float32) * 0.5
    a = sample_adaptive_chains(tparams, starts, sig, 32, 2, key=jax.random.PRNGKey(7))[0]
    b = sample_adaptive_chains(tparams, starts, sig, 32, 2, key=jax.random.PRNGKey(7))[0]
    c = sample_adaptive_chains(tparams, starts, sig, 32, 2, key=jax.random.PRNGKey(8))[0]
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_pool_student_t_proposal():
    """Student-t proposal scale: heavier-tailed steps accept less than the
    Gaussian walk with the same Cholesky, still finite and moving."""
    tparams = bimodal_target(2)
    starts = np.random.default_rng(0).normal(2, 1, (64, 2)).astype(np.float32)
    sig = np.eye(2, dtype=np.float32) * 0.64
    kw = dict(key=jax.random.PRNGKey(1), force_acceptance_max=1.0,
              force_acceptance_min=0.0)
    sg, rg = sample_adaptive_chains(tparams, starts, sig, 128, 1, **kw)
    st, rt = sample_adaptive_chains(tparams, starts, sig, 128, 1, dof=3.0, **kw)
    assert np.isfinite(np.asarray(st)).all()
    assert (np.asarray(rt) > 0).all()
    assert np.asarray(rt).mean() < np.asarray(rg).mean()


def test_sample_adaptive_chains_nan_policy():
    """continue_on_NaN parity with MarkovChain.run: default raises, True
    rejects NaN proposals and keeps the pool running."""
    def target(x):
        # NaN outside a band around the origin
        r2 = jnp.sum(x * x)
        return jnp.where(r2 < 4.0, -0.5 * r2, jnp.nan)

    starts = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError, match="NaN"):
        sample_adaptive_chains(target, starts, np.eye(2, dtype=np.float32) * 4.0,
                               32, 1, key=jax.random.PRNGKey(0))
    s, r = sample_adaptive_chains(target, starts,
                                  np.eye(2, dtype=np.float32) * 4.0,
                                  32, 1, key=jax.random.PRNGKey(0),
                                  continue_on_NaN=True)
    s = np.asarray(s)
    assert np.isfinite(s).all()
    assert (np.sum(s * s, axis=-1) < 4.0).all()


def test_sample_adaptive_chains_indicator():
    """An indicator restricts the support of a MixtureParams target: no
    sample lands outside, and a start outside fails loudly."""
    tparams = bimodal_target(2)
    ind = hyperrectangle(jnp.array([-10.0, -10.0]), jnp.array([2.0, 10.0]))
    starts = np.zeros((16, 2), np.float32)
    s, r = sample_adaptive_chains(
        tparams, starts, np.eye(2, dtype=np.float32) * 0.5, 64, 2,
        key=jax.random.PRNGKey(1), indicator=ind)
    assert (np.asarray(s).reshape(-1, 2)[:, 0] <= 2.0).all()
    bad = np.full((4, 2), 5.0, np.float32)
    with pytest.raises(ValueError, match="not finite"):
        sample_adaptive_chains(tparams, bad, np.eye(2, dtype=np.float32),
                               8, 1, indicator=ind)


def test_pool_d40_mixture_target():
    """D=40 Gaussian target: the pool runs, the chains move and stay on the
    target's scale."""
    from pypmc_tpu.density import core

    D, C = 40, 64
    tparams, _ = core.make_mixture(np.zeros((1, D), np.float32),
                                   np.array([np.eye(D, dtype=np.float32)]))
    starts = np.random.default_rng(0).normal(0, 1, (C, D)).astype(np.float32)
    s, r = sample_adaptive_chains(
        tparams, starts, np.eye(D, dtype=np.float32) * (2.38 ** 2 / D), 100, 2,
        key=jax.random.PRNGKey(2))
    s, r = np.asarray(s), np.asarray(r)
    assert s.shape == (C, 200, D) and np.isfinite(s).all()
    assert ((r > 0) & (r < 1)).all()
    assert abs(s[:, 100:].std() - 1.0) < 0.15
