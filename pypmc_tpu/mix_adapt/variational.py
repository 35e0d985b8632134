"""Variational-Bayes Gaussian-mixture inference ([Bis06] ch. 10.2).

Re-design of the reference's ``pypmc/mix_adapt/variational.pyx``: the three
N x K (x D^2) E-step hot loops (gauss exponent 10.64, responsibilities
10.46/10.49, S_k 10.53) and the M-step become single jitted XLA computations
over stacked hyperparameters; the Wishart/Dirichlet bound terms (10.71-10.77)
are fully vectorized over components.

The weighted-data variant of the reference (selected by swapping update
methods, ``variational.pyx:86-100``) collapses here into one code path with
weights = 1: the weighted formulas reduce to the unweighted ones exactly.

:class:`VBMerge` implements the [BGP10] mixture-compression variant, where
the "samples" are the L input components with virtual sample counts
``N * omega_l``.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as _np
from scipy.special import gammaln as _gammaln_host
from scipy.special import digamma as _digamma_host

from ..density.gauss import Gauss, chol_inv_det_host
from ..density.mixture import MixtureDensity, recover_gaussian_mixture as _unroll
from ..ops.linalg import chol_inv_det, symmetrize
from ..ops.lse import regularize, tiny

import logging

logger = logging.getLogger(__name__)

__all__ = [
    "GaussianInference",
    "VBMerge",
    "Wishart_log_B",
    "Wishart_expect_log_lambda",
    "Wishart_H",
    "Dirichlet_log_C",
]


# --------------------------------------------------------------------- #
# Wishart / Dirichlet helpers (vectorized over K; host-scalar API too)  #
# --------------------------------------------------------------------- #

def _wishart_log_B(D, nu, log_det):
    """(B.79) of [Bis06] on the log scale; ``nu``/``log_det`` may be arrays."""
    nu = jnp.asarray(nu)
    log_det = jnp.asarray(log_det)
    i = jnp.arange(1, D + 1, dtype=nu.dtype)
    gamma_terms = jnp.sum(
        jax.scipy.special.gammaln(0.5 * (nu[..., None] + 1.0 - i)), axis=-1
    )
    return (
        -0.5 * nu * log_det
        - 0.5 * nu * D * jnp.log(2.0)
        - 0.25 * D * (D - 1) * jnp.log(jnp.pi)
        - gamma_terms
    )


def _wishart_expect_log_lambda(D, nu, log_det):
    """(B.81) of [Bis06]: ``E[log |Lambda|]``; vectorized."""
    nu = jnp.asarray(nu)
    i = jnp.arange(1, D + 1, dtype=nu.dtype)
    return (
        jnp.sum(jax.scipy.special.digamma(0.5 * (nu[..., None] + 1.0 - i)), axis=-1)
        + D * jnp.log(2.0)
        + jnp.asarray(log_det)
    )


def _wishart_H(D, nu, log_det):
    """(B.82) of [Bis06]: Wishart entropy; vectorized."""
    log_B = _wishart_log_B(D, nu, log_det)
    expect = _wishart_expect_log_lambda(D, nu, log_det)
    return -log_B - 0.5 * (jnp.asarray(nu) - D - 1) * expect + 0.5 * jnp.asarray(nu) * D


def _dirichlet_log_C(alpha):
    """(B.23) of [Bis06]: Dirichlet normalization on the log scale."""
    alpha = jnp.asarray(alpha)
    return jax.scipy.special.gammaln(jnp.sum(alpha)) - jnp.sum(
        jax.scipy.special.gammaln(alpha)
    )


def Wishart_log_B(D, nu, log_det):
    """First part of a Wishart normalization, (B.79) of [Bis06], log scale.
    (Reference: ``variational.pyx:1220-1247``.)"""
    assert D > 0, "dimension must be positive, got %s" % D
    assert nu > D - 1, "Wishart dof must exceed D-1, got %s" % nu
    assert _np.isfinite(log_det), "log-determinant is not finite: %s" % log_det
    log_B = -0.5 * nu * log_det - 0.5 * nu * D * _np.log(2) - 0.25 * D * (D - 1) * _np.log(_np.pi)
    for i in range(1, D + 1):
        log_B -= _gammaln_host(0.5 * (nu + 1 - i))
    return log_B


def Wishart_expect_log_lambda(D, nu, log_det):
    r""":math:`E[\log |\Lambda|]`, (B.81) of [Bis06].
    (Reference: ``variational.pyx:1249-1258``.)"""
    assert D > 0, "dimension must be positive, got %s" % D
    assert nu > D - 1, "Wishart dof must exceed D-1, got %s" % nu
    assert _np.isfinite(log_det), "log-determinant is not finite: %s" % log_det
    result = 0.0
    for i in range(1, D + 1):
        result += _digamma_host(0.5 * (nu + 1 - i))
    return result + D * _np.log(2.0) + log_det


def Wishart_H(D, nu, log_det):
    """Entropy of the Wishart distribution, (B.82) of [Bis06].
    (Reference: ``variational.pyx:1260-1267``.)"""
    log_B = Wishart_log_B(D, nu, log_det)
    expect = Wishart_expect_log_lambda(D, nu, log_det)
    return -log_B - 0.5 * (nu - D - 1) * expect + 0.5 * nu * D


def Dirichlet_log_C(alpha):
    """Normalization constant of a Dirichlet distribution, log scale,
    (B.23) of [Bis06].  (Reference: ``variational.pyx:1269-1280``.)"""
    log_C = _gammaln_host(_np.sum(alpha))
    for alpha_k in alpha:
        log_C -= _gammaln_host(alpha_k)
    return log_C


# --------------------------------------------------------------------- #
# jitted E-step / M-step / bound kernels                                #
# --------------------------------------------------------------------- #

def _bilinear_with_W(x, m, W):
    """``(N, K)`` bilinear forms ``(x_n - m_k)^T W_k (x_n - m_k)`` computed
    via the Cholesky factors of the SPD ``W_k`` (``bilinear = ||C^T diff||^2``
    with ``W = C C^T``), mapped sequentially over K so only an ``(N, D)``
    intermediate exists per component (no ``(N, K, D)`` blowup)."""
    chol_W = jnp.linalg.cholesky(W)  # (K, D, D)

    def per_k(args):
        cw, mk = args
        proj = jnp.einsum("nd,di->ni", x - mk[None, :], cw, precision="highest")
        return jnp.sum(proj * proj, axis=-1)

    return jax.lax.map(per_k, (chol_W, m)).T


def _weighted_S(data, wr, x_mean, inv_N_comp):
    """``(K, D, D)`` scaled scatter matrices
    ``S_k = inv_N_k * sum_n wr_nk (x_n - xbar_k)(x_n - xbar_k)^T``
    (10.53); sequential over K to avoid an (N, K, D) intermediate."""
    def per_k(args):
        wr_k, mean_k, inv_k = args
        diff = data - mean_k[None, :]
        return inv_k * jnp.einsum("n,ni,nj->ij", wr_k, diff, diff,
                                  precision="highest")

    return jax.lax.map(per_k, (wr.T, x_mean, inv_N_comp))


class _EStepOut(NamedTuple):
    expectation_det_ln_lambda: jax.Array  # (K,)
    expectation_gauss_exponent: jax.Array  # (N, K)
    expectation_ln_pi: jax.Array  # (K,)
    log_rho: jax.Array  # (N, K) normalized log responsibilities
    r: jax.Array  # (N, K)
    N_comp: jax.Array  # (K,)
    inv_N_comp: jax.Array  # (K,)
    x_mean_comp: jax.Array  # (K, D)
    S: jax.Array  # (K, D, D)


def _normalize_log_rho(log_rho, dtype):
    """Max-shifted softmax of the responsibility logits (Bishop 10.49):
    returns ``(r, normalized log_rho)`` with exact zeros of ``r`` clamped
    to the dtype's tiny (the reference's regularization,
    ``variational.pyx:752-755``).  Shared by the GaussianInference and
    VBMerge E-steps so any normalization policy change applies to both."""
    max_rho = jnp.max(log_rho, axis=1, keepdims=True)
    shifted = log_rho - max_rho
    r = jnp.exp(shifted)
    norm = jnp.sum(r, axis=1, keepdims=True)
    r = r / norm
    log_rho = shifted - jnp.log(norm)
    r = jnp.where(r == 0.0, tiny(dtype), r)
    return r, log_rho


@jax.jit
def _vb_e_step(data, weights, alpha, beta, nu, m, W, log_det_W):
    """Standard VB-GMM E-step (10.64-10.66, 10.46/10.49, 10.51-10.53)."""
    N, D = data.shape
    dtype = data.dtype

    e_lnlam = _wishart_expect_log_lambda(D, nu, log_det_W)
    e_gauss = D / beta[None, :] + nu[None, :] * _bilinear_with_W(data, m, W)
    e_lnpi = jax.scipy.special.digamma(alpha) - jax.scipy.special.digamma(jnp.sum(alpha))

    # (10.46)
    log_rho = e_lnpi[None, :] + 0.5 * (
        e_lnlam[None, :] - D * jnp.log(2 * jnp.pi) - e_gauss
    )
    # (10.49): max-shifted softmax; store normalized log_rho, clamp r zeros
    r, log_rho = _normalize_log_rho(log_rho, dtype)

    wr = weights[:, None] * r
    N_comp = jnp.sum(wr, axis=0)  # (10.51)
    inv_N_comp = 1.0 / regularize(N_comp)
    x_mean = jnp.einsum("nk,ni->ki", wr, data,
                        precision="highest") * inv_N_comp[:, None]  # (10.52)
    S = _weighted_S(data, wr, x_mean, inv_N_comp)  # (10.53)

    return _EStepOut(e_lnlam, e_gauss, e_lnpi, log_rho, r, N_comp, inv_N_comp, x_mean, S)


@jax.jit
def _vb_merge_e_step(mu, sigma, Nomega, alpha, beta, nu, m, W, log_det_W):
    """[BGP10] E-step over L input components (eqs. (40)-(44))."""
    L, D = mu.shape
    dtype = mu.dtype

    e_lnlam = _wishart_expect_log_lambda(D, nu, log_det_W)
    e_gauss = D / beta[None, :] + nu[None, :] * _bilinear_with_W(mu, m, W)
    e_lnpi = jax.scipy.special.digamma(alpha) - jax.scipy.special.digamma(jnp.sum(alpha))

    # (40): log rho_lk = 0.5 * Nomega_l * (2 E[ln pi] + E[ln Lam] - D ln 2pi
    #                                      - E[gauss exponent]_lk)
    tmp_k = 2.0 * e_lnpi + e_lnlam - D * jnp.log(2.0 * jnp.pi)
    log_rho = 0.5 * (Nomega[:, None] * tmp_k[None, :] - Nomega[:, None] * e_gauss)

    r, log_rho = _normalize_log_rho(log_rho, dtype)

    # (41): N_comp itself is regularized in the reference (``:1171-1175``)
    N_comp = regularize(jnp.einsum("l,lk->k", Nomega, r, precision="highest"))
    inv_N_comp = 1.0 / N_comp
    # (42)
    x_mean = jnp.einsum("k,l,lk,li->ki", inv_N_comp, Nomega, r, mu, precision="highest")
    # (43)+(44) combined: S_k += Nomega_l r_lk ((mu_l - xbar_k)(..)^T + sigma_l)
    wr = Nomega[:, None] * r

    def per_k(args):
        wr_k, mean_k, inv_k = args
        diff = mu - mean_k[None, :]
        outer = jnp.einsum("l,li,lj->ij", wr_k, diff, diff, precision="highest")
        sig = jnp.einsum("l,lij->ij", wr_k, sigma, precision="highest")
        return inv_k * (outer + sig)

    S = jax.lax.map(per_k, (wr.T, x_mean, inv_N_comp))

    return _EStepOut(e_lnlam, e_gauss, e_lnpi, log_rho, r, N_comp, inv_N_comp, x_mean, S)


@jax.jit
def _vb_m_step(N_comp, x_mean, S, alpha0, beta0, nu0, m0, inv_W0):
    """VB-GMM M-step (10.58, 10.60-10.63)."""
    nu = nu0 + N_comp
    alpha = alpha0 + N_comp
    beta = beta0 + N_comp
    m = (beta0[:, None] * m0 + N_comp[:, None] * x_mean) / beta[:, None]  # (10.61)
    # (10.62): W_k^{-1} = W0^{-1} + N_k S_k
    #          + (beta0 N_k / (beta0 + N_k)) (xbar - m0)(xbar - m0)^T
    diff = x_mean - m0
    outer = jnp.einsum("ki,kj->kij", diff, diff, precision="highest")
    factor = beta0 * N_comp / (beta0 + N_comp)
    cov = inv_W0 + N_comp[:, None, None] * S + factor[:, None, None] * outer
    res = chol_inv_det(symmetrize(cov))
    W = res.inv
    log_det_W = -res.log_det
    return alpha, beta, nu, m, W, log_det_W


@jax.jit
def _vb_bound(weights, e: _EStepOut, alpha, beta, nu, m, W, log_det_W,
              alpha0, beta0, nu0, m0, inv_W0, log_det_W0):
    """Likelihood lower bound, the seven terms (10.71)-(10.77)."""
    K, D = m.shape
    N_comp, x_mean, S, r, log_rho = e.N_comp, e.x_mean_comp, e.S, e.r, e.log_rho
    e_lnlam, e_lnpi = e.expectation_det_ln_lambda, e.expectation_ln_pi

    # (10.71)
    diff = x_mean - m
    quad = jnp.einsum("ki,kij,kj->k", diff, W, diff, precision="highest")
    tr_SW = jnp.einsum("kij,kji->k", S, W, precision="highest")
    log_p_X = 0.5 * jnp.sum(
        N_comp * (e_lnlam - D / beta - nu * (tr_SW + quad) - D * jnp.log(2 * jnp.pi))
    )
    # (10.72)
    log_p_Z = jnp.einsum("k,k", N_comp, e_lnpi, precision="highest")
    # (10.73)
    log_p_pi = _dirichlet_log_C(alpha0) + jnp.einsum("k,k", alpha0 - 1, e_lnpi,
                                                     precision="highest")
    # (10.74)
    diff0 = m - m0
    quad0 = jnp.einsum("ki,kij,kj->k", diff0, W, diff0, precision="highest")
    tr_invW0_W = jnp.einsum("kij,kji->k", inv_W0, W, precision="highest")
    log_p_mu_lambda = 0.5 * jnp.sum(
        D * jnp.log(beta0 / (2.0 * jnp.pi))
        + e_lnlam
        - D * beta0 / beta
        - beta0 * nu * quad0
        + 2.0 * _wishart_log_B(D, nu0, log_det_W0)
        + (nu0 - D - 1) * e_lnlam
        - nu * tr_invW0_W
    )
    # (10.75) (weighted)
    log_q_Z = jnp.einsum("n,nk,nk", weights, r, log_rho, precision="highest")
    # (10.76)
    log_q_pi = (jnp.einsum("k,k", alpha - 1, e_lnpi, precision="highest")
                + _dirichlet_log_C(alpha))
    # (10.77)
    log_q_mu_lambda = (
        -0.5 * K * D
        + jnp.sum(0.5 * (e_lnlam + D * jnp.log(beta / (2 * jnp.pi))))
        - jnp.sum(_wishart_H(D, nu, log_det_W))
    )
    return (
        log_p_X + log_p_Z + log_p_pi + log_p_mu_lambda
        - log_q_Z - log_q_pi - log_q_mu_lambda
    )


@jax.jit
def _vb_update_bound(data, weights, N_comp, x_mean, S,
                     alpha0, beta0, nu0, m0, inv_W0, log_det_W0):
    """One full VB iteration -- M-step, E-step, likelihood bound, finiteness
    flag -- as a SINGLE compiled computation.  ``run()`` uses this instead of
    three separate dispatches (M/E/bound), and the separate E-step's
    finiteness checks would force two extra device syncs per iteration.
    """
    alpha, beta, nu, m, W, log_det_W = _vb_m_step(
        N_comp, x_mean, S, alpha0, beta0, nu0, m0, inv_W0)
    e = _vb_e_step(data, weights, alpha, beta, nu, m, W, log_det_W)
    bound = _vb_bound(weights, e, alpha, beta, nu, m, W, log_det_W,
                      alpha0, beta0, nu0, m0, inv_W0, log_det_W0)
    finite = (jnp.all(jnp.isfinite(e.r)) & jnp.all(jnp.isfinite(e.S)))
    # pack the two host-visible scalars into ONE array: one device->host
    # fetch per iteration
    bound_finite = jnp.stack([bound, finite.astype(bound.dtype)])
    return (alpha, beta, nu, m, W, log_det_W), e, bound_finite


# --------------------------------------------------------------------- #
# user-facing classes                                                   #
# --------------------------------------------------------------------- #

class GaussianInference(object):
    r"""Approximate a probability density by a Gaussian mixture with
    variational Bayes ([Bis06] ch. 10.2).
    (Reference: ``mix_adapt/variational.pyx:27-1033``.)

    Typical usage: call :meth:`run` until convergence, then either inspect
    the responsibility matrix ``self.r`` (clustering) or extract the mixture
    density at the mode of the variational posterior with
    :meth:`make_mixture`.

    :param data: ``(N, D)`` matrix-like array of samples.
    :param components: Integer K (detected from ``initial_guess`` if that is
        a mixture).
    :param weights: optional ``(N,)`` nonnegative finite sample weights
        (normalized to sum N internally).
    :param initial_guess: "first" | "random" | a Gaussian
        :class:`~pypmc_tpu.density.mixture.MixtureDensity` whose parameters
        seed ``m``, ``W`` and ``alpha``.

    All further keyword arguments are processed by
    :meth:`set_variational_parameters`.
    """

    def __init__(self, data, components=0, weights=None, initial_guess="first",
                 mesh=None, **kwargs):
        if isinstance(data, jax.Array):
            # keep device placement/sharding: with the particle axis sharded
            # over a mesh, the jitted E-step's sums over n are auto-reduced
            # across devices by GSPMD (the VB analog of the PMC psum path)
            if data.ndim == 1:
                data = data[:, None]
            self.data = data
        else:
            data = _np.asarray(data, dtype=float)
            if data.ndim == 1:
                data = data.reshape(len(data), 1)
            self.data = jnp.asarray(data)
        self.N = int(self.data.shape[0])
        self.dim = int(self.data.shape[1])
        if weights is not None:
            if not isinstance(weights, jax.Array):
                weights = _np.asarray(weights, dtype=float)
                assert _np.isfinite(weights).all(), (
                    "sample weights contain inf/nan:\n" + str(weights)
                )
            assert weights.shape == (self.N,), (
                "got %s samples but %s weights"
                % (self.N, weights.shape[0])
            )
            sum_w = float(jnp.sum(jnp.asarray(weights)))
            assert sum_w > 0, "total sample weight must be positive, got %g" % sum_w
            # normalize weights to N (not one); weighted update formulae
            # reduce to the unweighted ones when weights are all 1
            self.weights = jnp.asarray(weights) * (self.N / sum_w)
        else:
            self.weights = jnp.ones((self.N,), dtype=self.data.dtype)

        if mesh is not None:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as _P

            axis = mesh.axis_names[0]
            # N not divisible by the device count: pad with ZERO-WEIGHT
            # samples -- every E-step statistic is a weight-weighted sum, so
            # the padding contributes exactly nothing (the reference's MPI
            # sampler likewise accepts any N).  ``N`` stays the true count;
            # the (N, K) E-step fields are sliced back to it.
            pad = (-self.N) % mesh.devices.size
            data, weights = self.data, self.weights
            if pad:
                data = jnp.concatenate(
                    [data, jnp.broadcast_to(data[:1], (pad, self.dim))])
                weights = jnp.concatenate(
                    [weights, jnp.zeros((pad,), weights.dtype)])
            # with the particle axis sharded over the mesh, the jitted
            # E-step's sums over n are reduced across devices by GSPMD (the
            # VB analog of the PMC psum path)
            self.data = jax.device_put(data, NamedSharding(mesh, _P(axis, None)))
            self.weights = jax.device_put(weights, NamedSharding(mesh, _P(axis)))

        self._initialize_K(initial_guess, components, kwargs)
        self.set_variational_parameters(initial_guess=initial_guess, **kwargs)
        if not isinstance(initial_guess, str):
            self._parse_initial_guess(initial_guess)

        # valid bound computable right after construction
        self.E_step()

    # ---------------- initialization helpers ---------------- #

    def _check_initial_guess(self, initial_guess, other_args):
        for name in ("m", "W", "alpha", "beta", "nu"):
            if name in other_args:
                raise ValueError("Specify EITHER ``%s`` OR ``initial_guess``" % name)

    def _initialize_K(self, initial_guess, components, kwargs):
        if not isinstance(initial_guess, str):
            self.K = len(initial_guess)
            self._check_initial_guess(initial_guess, kwargs)
        elif components > 0:
            self.K = int(components)
        else:
            raise ValueError(
                "Specify either `components` or a mixture density as "
                "`initial_guess` to set the initial values"
            )

    def _check_K_vector(self, name, min=0.0):
        v = getattr(self, name)
        if len(v.shape) != 1:
            raise ValueError("hyperparameter %s must be 1-D, got shape %s" % (name, v.shape))
        if len(v) != self.K:
            raise ValueError("hyperparameter %s has length %d, expected K=%d" % (name, len(v), self.K))
        if not (_np.asarray(v) > min).all():
            raise ValueError(
                "every element of %s must be > %g, got %s=%s" % (name, min, name, v)
            )

    def _initialize_m(self, initial_guess):
        if self.K > self.N:
            raise ValueError(
                "Can't auto-initialize ``m`` with more output components than"
                " samples. Specify ``m`` explicitly."
            )
        if initial_guess == "first":
            return _np.asarray(self.data[: self.K]).copy()
        elif initial_guess == "random":
            return _np.asarray(self.data)[
                _np.random.choice(self.N, size=self.K, replace=False)
            ].copy()
        else:
            raise ValueError("unrecognized initial_guess %r (want a MixtureDensity or one of the named schemes)" % (initial_guess,))

    def set_variational_parameters(self, *args, **kwargs):
        r"""Reset prior (subscript 0) and initial posterior hyperparameters
        of the Gauss-Wishart/Dirichlet variational distributions:
        ``alpha0/alpha`` (Dirichlet), ``beta0/beta``, ``nu0/nu`` (Wishart
        dof, must exceed D-1), ``m0/m`` (K x D means), ``W0/W`` (K x D x D
        Wishart scale matrices).  Scalars are promoted to K-vectors; see the
        reference (``variational.pyx:361-569``) for the full semantics.
        """
        if args:
            raise TypeError("positional arguments are not accepted here; use keyword=value")

        K, dim = self.K, self.dim

        def promote_K(value):
            value = _np.asarray(value, dtype=float)
            if value.ndim == 0:
                value = value * _np.ones(K)
            return value

        self.alpha0 = promote_K(kwargs.pop("alpha0", 1e-5))
        self._check_K_vector("alpha0")
        self.alpha = promote_K(kwargs.pop("alpha", _np.ones(K) * self.alpha0))
        self._check_K_vector("alpha")

        # in the limit beta --> 0: uniform prior
        self.beta0 = promote_K(kwargs.pop("beta0", 1e-5))
        self._check_K_vector("beta0")
        self.beta = promote_K(kwargs.pop("beta", _np.ones(K) * self.beta0))
        self._check_K_vector("beta")

        # allowed values: nu > dim - 1
        nu_min = dim - 1.0
        self.nu0 = promote_K(kwargs.pop("nu0", nu_min + 1e-5))
        self._check_K_vector("nu0", min=nu_min)
        self.nu = promote_K(kwargs.pop("nu", self.nu0 * _np.ones(K)))
        self._check_K_vector("nu", min=nu_min)

        self.m0 = _np.array(kwargs.pop("m0", _np.zeros(dim)), dtype=float)
        if self.m0.shape == (dim,):
            self.m0 = _np.vstack([self.m0] * K)

        initial_guess = kwargs.pop("initial_guess")

        self.m = kwargs.pop("m", None)
        if self.m is None:
            if isinstance(initial_guess, str):
                self.m = self._initialize_m(initial_guess)
            else:
                # placeholder; overwritten by _parse_initial_guess
                self.m = _np.linspace(-1.0, 1.0, K * dim).reshape((K, dim))
        else:
            self.m = _np.array(self.m, dtype=float)
        for name in ("m0", "m"):
            if getattr(self, name).shape != (K, dim):
                raise ValueError(
                    "%s has shape %s, expected (K, d) = %s"
                    % (name, getattr(self, name).shape, (K, dim))
                )

        W0 = kwargs.pop("W0", None)
        if W0 is None:
            self.W0 = _np.array([_np.eye(dim)] * K)
            self.inv_W0 = self.W0.copy()
            self.log_det_W0 = _np.zeros(K)
        else:
            W0 = _np.asarray(W0, dtype=float)
            if W0.shape == (dim, dim):
                _, inv_W0, log_det = chol_inv_det_host(W0)
                self.W0 = _np.array([W0] * K)
                self.inv_W0 = _np.array([inv_W0] * K)
                self.log_det_W0 = _np.array([log_det] * K)
            elif W0.shape == (K, dim, dim):
                self.W0 = W0.copy()
                self.inv_W0 = _np.empty_like(self.W0)
                self.log_det_W0 = _np.empty(K)
                for k in range(K):
                    _, self.inv_W0[k], self.log_det_W0[k] = chol_inv_det_host(W0[k])
            else:
                raise ValueError(
                    "W0 must be None, a %s matrix, or a stacked %s array"
                    % ((dim, dim), (K, dim, dim))
                )
        self.W = _np.asarray(kwargs.pop("W", self.W0.copy()), dtype=float)
        if self.W.shape != (K, dim, dim):
            raise ValueError(
                "W has shape %s, expected (K, d, d) = %s"
                % (self.W.shape, (K, dim, dim))
            )
        # check W is a valid covariance and compute the determinant
        self.log_det_W = _np.array([chol_inv_det_host(W)[2] for W in self.W])

        if kwargs:
            raise TypeError("unknown keyword argument(s): " + str(kwargs.keys()))

    def _parse_initial_guess(self, initial_guess):
        """Seed the posterior hyperparameters from a Gaussian mixture
        (``variational.pyx:646-673``)."""
        means, covs, component_weights = _unroll(initial_guess)
        N, K = self.N, self.K

        # solve Dirichlet mode as function of alpha
        c_alpha = _np.sum(self.alpha0) + N
        self.alpha = component_weights * (c_alpha - K) + 1
        self.beta = self.beta0 + N * component_weights
        self.nu = self.nu0 + N * component_weights

        assert (self.alpha > 0.0).all()
        assert (self.beta > 0.0).all()
        assert (self.nu > self.dim - 1).all()

        self.m = means
        self.W = _np.empty_like(covs)
        self.log_det_W = _np.empty(K)
        for k in range(K):
            covs[k] = covs[k] * (self.nu[k] - self.dim)
            _, self.W[k], log_det = chol_inv_det_host(covs[k])
            self.log_det_W[k] = -log_det  # det(W) = det(Cov^-1)

    # ---------------- E / M / bound ---------------- #

    def _e_step_kernel(self):
        return _vb_e_step(
            self.data, self.weights,
            jnp.asarray(self.alpha), jnp.asarray(self.beta), jnp.asarray(self.nu),
            jnp.asarray(self.m), jnp.asarray(self.W), jnp.asarray(self.log_det_W),
        )

    def E_step(self):
        """Compute expectation values and summary statistics (one jitted
        kernel; reference order ``variational.pyx:116-127``)."""
        out = self._e_step_kernel()
        if not bool(jnp.all(jnp.isfinite(out.r))):
            raise _np.linalg.LinAlgError(
                "responsibility update produced inf/nan:\n" + str(out.r)
            )
        if not bool(jnp.all(jnp.isfinite(out.S))):
            raise _np.linalg.LinAlgError(
                "sample-covariance update produced inf/nan:\n" + str(out.S)
            )
        self._e = out
        self.expectation_det_ln_lambda = out.expectation_det_ln_lambda
        self.expectation_ln_pi = out.expectation_ln_pi
        self.N_comp = out.N_comp
        self.inv_N_comp = out.inv_N_comp
        self.x_mean_comp = out.x_mean_comp
        self.S = out.S

    @property
    def r(self):
        """(N, K) responsibility matrix (10.49)."""
        return self._e.r[: self.N]

    @property
    def log_rho(self):
        return self._e.log_rho[: self.N]

    @property
    def expectation_gauss_exponent(self):
        return self._e.expectation_gauss_exponent[: self.N]

    def M_step(self):
        """Update the Gauss-Wishart/Dirichlet parameters (one jitted
        kernel)."""
        alpha, beta, nu, m, W, log_det_W = _vb_m_step(
            self.N_comp, self.x_mean_comp, self.S,
            jnp.asarray(self.alpha0), jnp.asarray(self.beta0), jnp.asarray(self.nu0),
            jnp.asarray(self.m0), jnp.asarray(self.inv_W0),
        )
        self.alpha, self.beta, self.nu = alpha, beta, nu
        self.m, self.W, self.log_det_W = m, W, log_det_W

    def update(self):
        """One M-step followed by one E-step."""
        self.M_step()
        self.E_step()

    def _update_with_bound(self):
        """One iteration of :meth:`run`: M-step, E-step, and likelihood
        bound in a SINGLE compiled dispatch (see :func:`_vb_update_bound`);
        returns the bound as a float.  Semantics identical to
        ``update(); likelihood_bound()``."""
        # device copies of the prior hyperparameters, re-uploaded only when
        # the priors themselves are replaced (prune / posterior2prior /
        # set_variational_parameters), not on every iteration
        src = (self.alpha0, self.beta0, self.nu0, self.m0, self.inv_W0,
               self.log_det_W0)
        cached = getattr(self, "_pri_cache", None)
        if cached is None or any(a is not b for a, b in zip(cached[0], src)):
            cached = (src, tuple(jnp.asarray(v) for v in src))
            self._pri_cache = cached
        hyper, e, bound_finite = _vb_update_bound(
            self.data, self.weights, self.N_comp, self.x_mean_comp, self.S,
            *cached[1])
        bf = _np.asarray(bound_finite)  # the ONLY host sync of the iteration
        bound = float(bf[0])
        if not bool(bf[1]):
            raise _np.linalg.LinAlgError(
                "Encountered inf or nan in update of responsibilities or"
                " sample covariance"
            )
        self.alpha, self.beta, self.nu, self.m, self.W, self.log_det_W = hyper
        self._e = e
        self.expectation_det_ln_lambda = e.expectation_det_ln_lambda
        self.expectation_ln_pi = e.expectation_ln_pi
        self.N_comp = e.N_comp
        self.inv_N_comp = e.inv_N_comp
        self.x_mean_comp = e.x_mean_comp
        self.S = e.S
        return bound

    def likelihood_bound(self):
        """Lower bound on the true log marginal likelihood given the current
        parameter estimates ((10.71)-(10.77))."""
        return float(_vb_bound(
            self.weights, self._e,
            jnp.asarray(self.alpha), jnp.asarray(self.beta), jnp.asarray(self.nu),
            jnp.asarray(self.m), jnp.asarray(self.W), jnp.asarray(self.log_det_W),
            jnp.asarray(self.alpha0), jnp.asarray(self.beta0), jnp.asarray(self.nu0),
            jnp.asarray(self.m0), jnp.asarray(self.inv_W0), jnp.asarray(self.log_det_W0),
        ))

    # ---------------- posterior export / warm restart ---------------- #

    def make_mixture(self):
        """Return the Gaussian mixture at the mode of the variational
        posterior, skipping components with undefined Dirichlet or
        Gauss-Wishart modes (``variational.pyx:138-192``)."""
        components = []
        weights = []
        skipped = []
        alpha = _np.asarray(self.alpha)
        nu = _np.asarray(self.nu)
        m = _np.asarray(self.m)
        W_arr = _np.asarray(self.W)
        for k in range(self.K):
            pi = alpha[k] - 1.0
            if pi <= 0:
                logger.warning("component %i has zero weight; leaving it out of the mixture" % k)
                skipped.append(k)
                continue
            if nu[k] <= self.dim:
                logger.warning("component %i: Gauss-Wishart mode undefined (nu <= D); leaving it out" % k)
                skipped.append(k)
                continue
            try:
                lam = (nu[k] - self.dim) * W_arr[k]  # mode of the Wishart
                cov = chol_inv_det_host(lam)[1]
                components.append(Gauss(m[k], cov))
            except Exception as error:
                logger.error(
                    "component %i could not be built (%s); leaving it out" % (k, repr(error))
                )
                skipped.append(k)
                continue
            weights.append(pi)

        if skipped:
            logger.warning("The following components have been skipped: %s" % skipped)

        return MixtureDensity(components, weights)

    def posterior2prior(self):
        """Return the posterior hyperparameters as a kwargs dict usable to
        construct a new instance with this posterior as prior."""
        return dict(
            alpha0=_np.asarray(self.alpha).copy(), beta0=_np.asarray(self.beta).copy(),
            nu0=_np.asarray(self.nu).copy(), m0=_np.asarray(self.m).copy(),
            W0=_np.asarray(self.W).copy(), components=self.K,
        )

    def prior_posterior(self):
        """Return prior and posterior values of all variational parameters
        as a dict."""
        return dict(
            alpha0=_np.asarray(self.alpha0).copy(), beta0=_np.asarray(self.beta0).copy(),
            m0=_np.asarray(self.m0).copy(), nu0=_np.asarray(self.nu0).copy(),
            W0=_np.asarray(self.W0).copy(), alpha=_np.asarray(self.alpha).copy(),
            beta=_np.asarray(self.beta).copy(), m=_np.asarray(self.m).copy(),
            nu=_np.asarray(self.nu).copy(), W=_np.asarray(self.W).copy(),
            components=self.K,
        )

    # ---------------- prune / run ---------------- #

    _vmembers = ("alpha0", "alpha", "beta0", "beta", "nu0", "nu", "m0", "m",
                 "W0", "inv_W0", "W", "log_det_W", "log_det_W0")

    def prune(self, threshold=1.0):
        r"""Delete components with effective sample count ``N_k`` below the
        ``threshold`` (0 disables); reindex all hyperparameters and recompute
        the expectation values (``variational.pyx:233-281``)."""
        if not threshold:
            return

        survivors = _np.where(_np.asarray(self.N_comp) >= threshold)[0]
        K = len(survivors)
        if K == 0:
            raise ValueError(
                "prune threshold %g would kill every component" % threshold
            )
        if K == self.K:
            return
        self.K = K
        for name in self._vmembers:
            setattr(self, name, _np.asarray(getattr(self, name))[survivors])
        self.E_step()

    def run(self, iterations=1000, prune=1.0, rel_tol=1e-10, abs_tol=1e-5):
        r"""Run VB updates until convergence of the likelihood bound
        (reference protocol, ``variational.pyx:283-359``: converge only when
        the bound increased and the number of components is unchanged;
        ``prune`` removes components with ``N_k`` below that threshold after
        every update).

        Return the number of iterations at convergence, or None.
        """
        old_K = None
        bound = None
        for i in range(1, iterations + 1):
            if self.K == old_K:
                old_bound = bound
            else:
                old_bound = self.likelihood_bound()
                logger.info(
                    "K changed to %d; fresh likelihood bound %g (N_k=%s)",
                    self.K, old_bound, self.N_comp,
                )

            bound = self._update_with_bound()

            logger.info(
                "VB iteration %d: bound %.15g with K=%d, N_k=%s",
                i, bound, self.K, self.N_comp,
            )

            if bound < old_bound:
                logger.warning(
                    "likelihood bound dropped this iteration (%g -> %g)",
                    old_bound, bound,
                )

            if bound == old_bound:
                return i
            diff = bound - old_bound
            if diff > 0:
                if abs(bound) < abs_tol:
                    if abs(diff) < abs_tol:
                        return i
                else:
                    if abs(diff / bound) < rel_tol:
                        return i

            old_K = self.K
            self.prune(prune)
        return None


class VBMerge(GaussianInference):
    """Parsimonious reduction of a Gaussian mixture with variational Bayes
    [BGP10]: compress an ``L``-component ``input_mixture`` (fitted to ``N``
    virtual samples) into at most ``components`` output components without
    the original samples.  (Reference: ``variational.pyx:1035-1218``.)

    :param input_mixture: Gaussian
        :class:`~pypmc_tpu.density.mixture.MixtureDensity` to be compressed.
    :param N: number of (virtual) input samples the mixture is based on.
    :param components: maximum number of output components (ignored when
        ``initial_guess`` is a mixture).
    :param initial_guess: "first" | "random" | a Gaussian mixture seeding
        the output.

    All other keyword arguments as in
    :meth:`GaussianInference.set_variational_parameters`.
    """

    def __init__(self, input_mixture, N, components=0, initial_guess="first",
                 **kwargs):
        self.input = input_mixture
        self.L = len(input_mixture.components)
        means, covs, input_weights = _unroll(input_mixture)
        self.mu = jnp.asarray(means)
        self.sigma = jnp.asarray(covs)

        self._initialize_K(initial_guess, components, kwargs)
        self.dim = int(means.shape[1])
        self.N = N
        # effective number of samples per input component (N * omega)
        self.Nomega = jnp.asarray(N * input_weights)
        # bound's log_q_Z term runs over L pseudo-points with unit weight
        self.weights = jnp.ones((self.L,), dtype=self.mu.dtype)

        self.set_variational_parameters(initial_guess=initial_guess, **kwargs)
        if not isinstance(initial_guess, str):
            self._parse_initial_guess(initial_guess)

        self.E_step()

    def _initialize_m(self, initial_guess):
        if self.K > self.L:
            raise ValueError(
                "Can't auto-initialize ``m`` with more output components than"
                " input components. Specify ``m`` explicitly."
            )
        if initial_guess == "first":
            return _np.asarray(self.mu[: self.K]).copy()
        elif initial_guess == "random":
            indices = _np.random.choice(self.L, size=self.K, replace=False)
            return _np.asarray(self.mu)[indices].copy()
        else:
            raise ValueError("unrecognized initial_guess %r (want a MixtureDensity or one of the named schemes)" % (initial_guess,))

    def _update_with_bound(self):
        self.update()
        return self.likelihood_bound()

    def _e_step_kernel(self):
        return _vb_merge_e_step(
            self.mu, self.sigma, self.Nomega,
            jnp.asarray(self.alpha), jnp.asarray(self.beta), jnp.asarray(self.nu),
            jnp.asarray(self.m), jnp.asarray(self.W), jnp.asarray(self.log_det_W),
        )
