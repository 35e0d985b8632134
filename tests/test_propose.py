"""The proposal draw and its evaluation (``propose_T``, ``propose_logq_T``):
shape edges, the latent distribution, dead components, Student-t moments
and determinism per key."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pypmc_tpu.density.core as core


def make_mixture(K=3, D=4, seed=1, student_t=True, dead=False):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 2, (K, D)).astype(np.float32)
    a = rng.normal(0, 0.2, (K, D, D)).astype(np.float32)
    covs = np.eye(D, dtype=np.float32)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K).astype(np.float32)
    if dead:
        w[1] = 0.0
    w /= w.sum()
    dofs = rng.uniform(5, 12, K).astype(np.float32) if student_t else None
    params, valid = core.make_mixture(means, covs, w, dofs)
    assert bool(np.asarray(valid).all())
    return params, means, covs, w, dofs


def test_latent_abundance_and_dead_components():
    """The inverse-CDF component draw matches the mixture weights (binomial
    4-sigma), and dead components are NEVER drawn."""
    params, *_ = make_mixture(K=4, D=3, dead=True)
    N = 1 << 14
    lat = np.asarray(core.propose_logq_T(params, jax.random.PRNGKey(5), N)[1])
    counts = np.bincount(lat, minlength=4)
    assert counts[1] == 0
    w = np.asarray(params.weights)
    for k in (0, 2, 3):
        sd = np.sqrt(N * w[k] * (1 - w[k]))
        assert abs(counts[k] - N * w[k]) < 4 * sd


def test_dead_trailing_component_never_drawn():
    """A dead LAST component: the tail-sum thresholds end at exactly 1, so
    no uniform draw can fall into its (empty) interval."""
    params, *_ = make_mixture(K=3, D=2, student_t=False)
    w = np.array([0.3, 0.7, 0.0], np.float32)
    params = dataclasses.replace(params, weights=jnp.asarray(w))
    lat = np.asarray(core.propose_T(params, jax.random.PRNGKey(0), 1 << 16)[1])
    assert (lat < 2).all()


def test_propose_logq_matches_separate_evaluation():
    """log q and log p returned with the draw equal an independent
    evaluation of the very samples drawn."""
    params, *_ = make_mixture(K=3, D=4, student_t=True)
    tparams, *_ = make_mixture(K=2, D=4, seed=7, student_t=False)
    xT, lat, logq, logp = core.propose_logq_T(
        params, jax.random.PRNGKey(42), 4096, tparams)
    np.testing.assert_allclose(np.asarray(logq),
                               np.asarray(core.mixture_logpdf_T(params, xT)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(logp),
                               np.asarray(core.mixture_logpdf_T(tparams, xT)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K,D", [(1, 1), (1, 5), (2, 1), (7, 2), (3, 16)])
def test_propose_logq_shape_edges(K, D):
    """Single-component mixtures (the inverse-CDF latent sum reduces over
    ZERO thresholds), D=1, and an odd N.  Each case pins log q against the
    evaluation of the drawn samples and the latent distribution against the
    mixture weights."""
    rng = np.random.default_rng(K * 100 + D)
    means = rng.normal(0, 2, (K, D))
    a = rng.normal(0, 0.2, (K, D, D))
    covs = np.eye(D)[None] * 1.2 + np.einsum("kij,klj->kil", a, a)
    w = None if K == 1 else rng.dirichlet(np.full(K, 5.0))
    params, valid = core.make_mixture(means, covs, w)
    assert bool(np.asarray(valid).all())
    N = 4097
    xT, lat, logq = [np.asarray(o) for o in
                     core.propose_logq_T(params, jax.random.PRNGKey(5), N)]
    assert xT.shape == (D, N) and lat.shape == (N,) and logq.shape == (N,)
    assert np.isfinite(xT).all() and np.isfinite(logq).all()
    assert ((lat >= 0) & (lat < K)).all()
    logq_ref = np.asarray(core.mixture_logpdf_T(params, jnp.asarray(xT)))
    np.testing.assert_allclose(logq, logq_ref, rtol=1e-6, atol=1e-6)
    if K > 1:
        counts = np.bincount(lat, minlength=K) / N
        np.testing.assert_allclose(counts, np.asarray(params.weights),
                                   atol=4 * np.sqrt(0.25 / N) + 0.02)


def test_propose_student_t_moments():
    """Per-component sample moments of the Student-t draw: mean mu_k and
    covariance Sigma_k dof / (dof - 2)."""
    params, means, covs, w, dofs = make_mixture(K=3, D=4, student_t=True)
    xT, lat, _ = core.propose_logq_T(params, jax.random.PRNGKey(9), 1 << 15)
    xT, lat = np.asarray(xT), np.asarray(lat)
    for k in range(3):
        sel = xT[:, lat == k]
        exp_cov = covs[k] * dofs[k] / (dofs[k] - 2)
        assert np.abs(sel.mean(axis=1) - means[k]).max() < 0.1
        rel = np.abs(np.cov(sel) - exp_cov).max() / np.abs(exp_cov).max()
        assert rel < 0.1, (k, rel)


def test_propose_deterministic_per_key():
    params, *_ = make_mixture(K=2, D=3, student_t=False)
    a = core.propose_logq_T(params, jax.random.PRNGKey(1), 2048)
    b = core.propose_logq_T(params, jax.random.PRNGKey(1), 2048)
    c = core.propose_logq_T(params, jax.random.PRNGKey(2), 2048)
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert not np.array_equal(np.asarray(a[0]), np.asarray(c[0]))
