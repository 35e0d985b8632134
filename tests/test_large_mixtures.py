"""PMC and VB updates at the shapes of the large-mixture workloads,
(K, D) = (21, 10), (400, 2) and (64, 40), against plain float64 numpy
implementations of the same formulas ([Cap+08] eq. 14, [Bis06] 10.46-10.53)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.linalg import solve_triangular
from scipy.special import digamma, gammaln

from pypmc_tpu.density import core
from pypmc_tpu.mix_adapt.pmc import pmc_update
from pypmc_tpu.mix_adapt.variational import GaussianInference

SHAPES = [(21, 10), (400, 2), (64, 40)]


def make_mixture(K, D, student_t, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 3, (K, D))
    a = rng.normal(0, 0.3 / np.sqrt(D), (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    dofs = rng.uniform(4, 12, K) if student_t else None
    params, valid = core.make_mixture(means, covs, w, dofs)
    assert bool(np.asarray(valid).all())
    return params


def samples_from(params, per_component, seed=1):
    """Samples from the mixture, ``per_component * K`` of them, so that every
    component's weighted covariance is well determined."""
    n = per_component * params.K
    xT = core.propose_T(params, jax.random.PRNGKey(seed), n)[0]
    w = jax.random.uniform(jax.random.PRNGKey(seed + 1), (n,), xT.dtype, 0.5, 1.5)
    return np.asarray(xT, np.float64), np.asarray(w, np.float64)


def numpy_components(params, x):
    """float64 ``log q_k (K, N)`` and squared distances ``(K, N)``."""
    means = np.asarray(params.means)
    chol = np.asarray(params.chol)
    K, D = means.shape
    logq = np.empty((K, x.shape[1]))
    maha = np.empty_like(logq)
    for k in range(K):
        z = solve_triangular(chol[k], x - means[k][:, None], lower=True)
        maha[k] = np.sum(z * z, axis=0)
        hld = np.sum(np.log(np.diag(chol[k])))
        if params.dof is None:
            logq[k] = -0.5 * D * np.log(2 * np.pi) - hld - 0.5 * maha[k]
        else:
            nu = float(params.dof[k])
            logq[k] = (gammaln(0.5 * (nu + D)) - gammaln(0.5 * nu)
                       - 0.5 * D * np.log(nu * np.pi) - hld
                       - 0.5 * (nu + D) * np.log1p(maha[k] / nu))
    return logq, maha


def numpy_pmc(params, x, w):
    """[Cap+08] eq. (14) with Rao-Blackwellized responsibilities; Student-t
    means and covariances weighted by gamma = (nu + D) / (nu + maha)."""
    logq, maha = numpy_components(params, x)
    D = x.shape[0]
    lw = np.log(np.asarray(params.weights))[:, None] + logq
    m = lw.max(axis=0)
    rho = np.exp(lw - (m + np.log(np.exp(lw - m).sum(axis=0))))
    wr = rho * w[None, :]
    s0 = wr.sum(axis=1)
    c = wr
    if params.dof is not None:
        nu = np.asarray(params.dof)[:, None]
        c = wr * (nu + D) / (nu + maha)
    mu = (c @ x.T) / c.sum(axis=1)[:, None]
    cov = np.stack([np.einsum("n,in,jn->ij", c[k], x - mu[k][:, None],
                              x - mu[k][:, None]) / s0[k]
                    for k in range(params.K)])
    return s0 / w.sum(), mu, cov


@pytest.mark.parametrize("K,D,student_t", [
    (21, 10, False), (21, 10, True), (400, 2, False), (400, 2, True),
    (64, 40, False),
])
def test_pmc_update_matches_numpy(K, D, student_t):
    params = make_mixture(K, D, student_t)
    x, w = samples_from(params, 60 if D < 40 else 400)
    out = pmc_update(params, jnp.asarray(x), jnp.asarray(w), transposed=True,
                     dof_solver_steps=0)
    assert bool(np.asarray(out.updated_ok).all())
    alpha, mu, cov = numpy_pmc(params, x, w)
    np.testing.assert_allclose(np.asarray(out.params.weights), alpha,
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.params.means), mu,
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(out.params.cov), cov,
                               rtol=1e-7, atol=1e-10)


def numpy_vb_estep(x, weights, alpha, beta, nu, m, W):
    """[Bis06] (10.64-10.66, 10.46/10.49, 10.51-10.53), weighted."""
    N, D = x.shape
    K = len(alpha)
    log_det_W = np.linalg.slogdet(W)[1]
    e_lnlam = np.array([sum(digamma(0.5 * (nu[k] + 1 - i)) for i in range(1, D + 1))
                        for k in range(K)]) + D * np.log(2) + log_det_W
    diff = x[None, :, :] - m[:, None, :]                      # (K, N, D)
    quad = np.einsum("kni,kij,knj->kn", diff, W, diff)
    e_gauss = D / beta[:, None] + nu[:, None] * quad
    e_lnpi = digamma(alpha) - digamma(alpha.sum())
    log_rho = e_lnpi[:, None] + 0.5 * (e_lnlam[:, None] - D * np.log(2 * np.pi)
                                       - e_gauss)
    r = np.exp(log_rho - log_rho.max(axis=0))
    r /= r.sum(axis=0)
    wr = r * weights[None, :]
    N_k = wr.sum(axis=1)
    xbar = (wr @ x) / N_k[:, None]
    S = np.stack([np.einsum("n,ni,nj->ij", wr[k], x - xbar[k], x - xbar[k]) / N_k[k]
                  for k in range(K)])
    return N_k, xbar, S


@pytest.mark.parametrize("K,D", SHAPES)
def test_vb_estep_matches_numpy(K, D):
    params = make_mixture(K, D, False, seed=3)
    xT, w = samples_from(params, 30 if D < 40 else 200, seed=4)
    x = xT.T
    rng = np.random.default_rng(5)
    m = np.asarray(params.means) + rng.normal(0, 0.1, (K, D))
    nu = D + rng.uniform(2, 20, K)
    beta = rng.uniform(1, 5, K)
    alpha = rng.uniform(1, 5, K)
    W = np.asarray(params.inv_sigma) / nu[:, None, None]
    vb = GaussianInference(x, components=K, weights=w, m=m, W=W, nu=nu,
                           beta=beta, alpha=alpha)
    # GaussianInference normalizes the weights to sum N
    N_k, xbar, S = numpy_vb_estep(x, w * (len(w) / w.sum()), alpha, beta, nu, m, W)
    np.testing.assert_allclose(np.asarray(vb.N_comp), N_k, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(vb.x_mean_comp), xbar, rtol=1e-7,
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(vb.S), S, rtol=1e-6, atol=1e-9)
