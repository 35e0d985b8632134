"""The fused mixture log-density kernel (``pypmc_tpu.ops.mixture_kernel``)
in the Pallas interpreter, against a float64 numpy reference; its lowering
for the GPU; and the one function that chooses between it and XLA.

The kernel takes the transposed particle layout ``xT (D, N)``."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.linalg import solve_triangular
from scipy.special import gammaln

from pypmc_tpu.density import core
from pypmc_tpu.mix_adapt.pmc import calculate_rho_rb_T
from pypmc_tpu.ops import mixture_kernel as mk


def make_params(K, D, student_t, seed=0, dead=True, shift=0.0):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 2, size=(K, D)) + shift
    a = rng.normal(0, 0.3 / np.sqrt(D), size=(K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, size=K)
    if dead and K > 1:
        w[K // 2] = 0.0
    dofs = rng.uniform(3, 12, size=K).astype(np.float32) if student_t else None
    params, valid = core.make_mixture(
        means.astype(np.float32), covs.astype(np.float32), w.astype(np.float32),
        dofs)
    assert bool(np.asarray(valid).all())
    return params


def make_x(D, N, seed=1, shift=0.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray((rng.normal(0, 2, size=(D, N)) + shift).astype(np.float32))


def reference(params, xT):
    """float64 log q (N,) and rho (K, N) by Cholesky solves."""
    means = np.asarray(params.means, np.float64)
    chol = np.asarray(params.chol, np.float64)
    w = np.asarray(params.weights, np.float64)
    x = np.asarray(xT, np.float64)
    K, D = means.shape
    lw = np.full((K, x.shape[1]), -np.inf)
    for k in np.flatnonzero(w > 0):
        z = solve_triangular(chol[k], x - means[k][:, None], lower=True)
        maha = np.sum(z * z, axis=0)
        hld = np.sum(np.log(np.diag(chol[k])))
        if params.dof is None:
            lk = -0.5 * D * np.log(2 * np.pi) - hld - 0.5 * maha
        else:
            nu = float(params.dof[k])
            lk = (gammaln(0.5 * (nu + D)) - gammaln(0.5 * nu)
                  - 0.5 * D * np.log(nu * np.pi) - hld
                  - 0.5 * (nu + D) * np.log1p(maha / nu))
        lw[k] = np.log(w[k]) + lk
    m = lw.max(axis=0)
    logq = m + np.log(np.exp(lw - m).sum(axis=0))
    return logq, np.exp(lw - logq)


def kernel_logq(params, xT):
    return mk.mixture_logq(xT, *core._kernel_operands(params),
                           student_t=params.is_student_t, interpret=True)


def kernel_rho(params, xT):
    return mk.mixture_rho(xT, *core._kernel_operands(params),
                          student_t=params.is_student_t, interpret=True)


# float32 arithmetic over D(D+1)/2 products per component: the error of
# log q scales with its magnitude
def assert_logq_close(got, ref, rtol=1e-5):
    got = np.asarray(got, np.float64)
    np.testing.assert_array_less(np.abs(got - ref), rtol * (1 + np.abs(ref)))


@pytest.mark.parametrize("student_t", [False, True])
def test_logq_matches_reference(student_t):
    params = make_params(5, 3, student_t)
    xT = make_x(3, 1000)
    out = kernel_logq(params, xT)
    assert out.shape == (1000,) and out.dtype == jnp.float32
    assert_logq_close(out, reference(params, xT)[0])


@pytest.mark.parametrize("student_t", [False, True])
def test_rho_matches_reference(student_t):
    params = make_params(5, 3, student_t)
    xT = make_x(3, 1000)
    rho, logq = kernel_rho(params, xT)
    ref_q, ref_rho = reference(params, xT)
    assert rho.shape == (5, 1000)
    assert_logq_close(logq, ref_q)
    np.testing.assert_allclose(np.asarray(rho), ref_rho, rtol=1e-4, atol=1e-6)
    # the dead component has exactly zero responsibility
    assert np.all(np.asarray(rho)[2] == 0.0)
    np.testing.assert_allclose(np.asarray(rho).sum(axis=0), 1.0, atol=1e-5)


def test_maha_matches_reference():
    """Mahalanobis distances stay on the XLA path; pin them to float64."""
    params = make_params(5, 3, False)
    xT = make_x(3, 700)
    out = np.asarray(core.mahalanobis_all_T(params, xT))
    chol = np.asarray(params.chol, np.float64)
    means = np.asarray(params.means, np.float64)
    x = np.asarray(xT, np.float64)
    ref = np.stack([np.sum(solve_triangular(chol[k], x - means[k][:, None],
                                            lower=True) ** 2, axis=0)
                    for k in range(5)])
    assert out.shape == (5, 700)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [777, 2 * mk._block_size(3) + 3])
def test_padding_non_multiple_block(n):
    """N below one block, and N that leaves a ragged last block."""
    params = make_params(5, 3, True)
    xT = make_x(3, n)
    rho, logq = kernel_rho(params, xT)
    assert logq.shape == (n,) and rho.shape == (5, n)
    ref_q, ref_rho = reference(params, xT)
    assert_logq_close(logq, ref_q)
    np.testing.assert_allclose(np.asarray(rho), ref_rho, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kk,dd", [(7, 33), (2, 1), (40, 2), (1, 5)])
def test_odd_shapes_logq(kk, dd):
    """Ragged K and D, D=1 and a single component."""
    params = make_params(kk, dd, False, seed=kk + dd)
    xT = make_x(dd, 300)
    assert_logq_close(kernel_logq(params, xT), reference(params, xT)[0])


def test_large_kd():
    """K=64, D=40: the same kernel, no size gate."""
    params = make_params(64, 40, True, seed=2)
    xT = make_x(40, 200, seed=3)
    rho, logq = kernel_rho(params, xT)
    ref_q, ref_rho = reference(params, xT)
    assert_logq_close(logq, ref_q)
    np.testing.assert_allclose(np.asarray(rho), ref_rho, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("shift", [1e3, -4e3])
def test_logq_translation_invariant(shift):
    """The kernel subtracts the mixture centre first, so a rigid shift of
    mixture and particles leaves its error at the near-origin level: only
    the float32 rounding of the shifted inputs themselves remains."""
    params = make_params(5, 3, False, shift=shift)
    xT = make_x(3, 1000, shift=shift)
    out = np.asarray(kernel_logq(params, xT), np.float64)
    ref = reference(params, xT)[0]
    assert_logq_close(out, ref)


# ------------------------------------------------------------------ #
# path choice                                                         #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("backend,dtype,n,expected", [
    ("gpu", jnp.float32, mk.KERNEL_MIN_N, True),
    ("gpu", jnp.float32, mk.KERNEL_MIN_N - 1, False),
    ("gpu", jnp.float64, mk.KERNEL_MIN_N, False),
    ("cpu", jnp.float32, mk.KERNEL_MIN_N, False),
])
def test_path_choice(monkeypatch, backend, dtype, n, expected):
    """The kernel runs on the GPU, in float32, from KERNEL_MIN_N particles;
    every other case takes XLA."""
    monkeypatch.setattr(mk.jax, "default_backend", lambda: backend)
    assert mk.use_kernel(jax.ShapeDtypeStruct((4, n), dtype)) is expected


def test_dispatch_through_kernel(monkeypatch):
    """Where use_kernel says so, mixture_logpdf_T and calculate_rho_rb_T take
    the kernel and agree with the XLA path."""
    params = make_params(6, 4, True)
    xT = make_x(4, 1500)
    xla_q = np.asarray(core.mixture_logpdf_T(params, xT))
    xla_rho = np.asarray(calculate_rho_rb_T(params, xT))
    calls = []

    def spy(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, interpret=True, **kwargs)
        return wrapped

    monkeypatch.setattr(mk, "use_kernel", lambda x: True)
    monkeypatch.setattr(mk, "mixture_logq", spy(mk.mixture_logq))
    monkeypatch.setattr(mk, "mixture_rho", spy(mk.mixture_rho))
    q = np.asarray(core.mixture_logpdf_T(params, xT))
    rho = np.asarray(calculate_rho_rb_T(params, xT))
    assert calls == ["mixture_logq", "mixture_rho"]
    np.testing.assert_allclose(q, xla_q, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rho, xla_rho, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("K,D,student_t,rho", [
    (10, 10, True, False), (10, 10, True, True),
    (400, 2, False, True), (64, 40, True, False),
])
def test_kernel_lowers_for_gpu(K, D, student_t, rho):
    """The kernel lowers to a Triton call for the CUDA platform (checked
    here without a card: what the GPU compiler then says shows only on
    the card)."""
    params = make_params(K, D, student_t)
    xT = jax.ShapeDtypeStruct((D, 1 << 20), jnp.float32)
    ops = core._kernel_operands(params)
    fn = mk.mixture_rho if rho else mk.mixture_logq
    lowered = jax.jit(functools.partial(fn, student_t=student_t)).trace(
        xT, *ops).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "triton" in text
    assert ("mixture_rho" if rho else "mixture_logq") in text


def test_kernel_operands():
    """Centre at the weighted mean of the means, whitened means relative to
    it, and per-component coefficients with -inf marking a dead one."""
    params = make_params(5, 3, True)
    center, u, b, coef = map(np.asarray, core._kernel_operands(params))
    w = np.asarray(params.weights)
    means = np.asarray(params.means)
    np.testing.assert_allclose(center, (w[:, None] * means).sum(axis=0), rtol=1e-6)
    np.testing.assert_allclose(
        b, np.einsum("kij,kj->ki", np.asarray(params.inv_chol), means - center),
        rtol=1e-5, atol=1e-6)
    assert coef.shape == (5, 3)
    assert coef[2, 0] == -np.inf and np.isfinite(np.delete(coef, 2, axis=0)).all()
    np.testing.assert_allclose(coef[:, 1], 0.5 * (np.asarray(params.dof) + 3))
    np.testing.assert_allclose(coef[:, 2], 1.0 / np.asarray(params.dof), rtol=1e-6)
