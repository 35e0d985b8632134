"""Fused mixture log-density kernel for the GPU (Pallas, Triton route).

The XLA form of the mixture log-density (:func:`pypmc_tpu.density.core.mahalanobis`)
writes the whole ``(N, K, D)`` projection of the particles through one GEMM
and reads it back.  This kernel reads only the particles ``xT (D, N)`` and
writes ``log q (N,)`` -- or the responsibilities ``rho (K, N)`` and
``log q`` -- so the bytes moved are those of the inputs and outputs alone.

Layout of the kernel:

* one program per power-of-two block of particles; the block's ``D`` rows are
  loaded once and the mixture centre is subtracted first, so accuracy does
  not depend on where the particles sit;
* a loop over the ``K`` components inside the block, with an online weighted
  log-sum-exp (one ``exp`` per component and particle);
* per component the squared Mahalanobis distance
  ``|U_k (x - c) - b_k|^2`` with ``U_k = L_k^{-1}`` lower triangular, as
  ``D (D + 1) / 2`` explicit float32 multiply-adds: no tensor-core product, so
  no TF32 rounding;
* Student-t components through ``log1p(maha / dof)``; dead components
  (weight 0) give exactly 0 in ``rho``;
* the parameters are read from global memory, which the L2 cache holds, so
  every ``(K, D)`` takes the same kernel.

:func:`use_kernel` is the one place that decides between this kernel and the
XLA path.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["KERNEL_MIN_N", "use_kernel", "mixture_logq", "mixture_rho"]

# Below this many particles the launch and compile cost of a kernel outweigh
# the bytes it saves; XLA evaluates such batches.
KERNEL_MIN_N = 1 << 14


def use_kernel(xT) -> bool:
    """Whether the fused kernel evaluates particles like ``xT (D, N)``: on the
    GPU, in float32, for at least :data:`KERNEL_MIN_N` particles.  Every other
    case (CPU, float64, small batches) takes the XLA path."""
    return (jax.default_backend() == "gpu"
            and xT.dtype == jnp.float32
            and xT.shape[-1] >= KERNEL_MIN_N)


def _block_size(dim: int) -> int:
    """Particles per program: 4 warps of 32 threads, each thread holding
    ``per_thread`` particles of every one of the ``dim`` rows in registers.
    More particles per thread amortise the scalar parameter loads over more
    multiply-adds; ``dim * per_thread`` is kept to about 160 registers.  On
    the H100 this choice was the fastest of the powers of two measured at
    D=10 (8 per thread) and D=40 (4 per thread)."""
    per_thread = 1
    while per_thread < 8 and 2 * per_thread * dim <= 160:
        per_thread *= 2
    return 128 * per_thread


def _kernel(x_ref, c_ref, u_ref, b_ref, coef_ref, *out_refs, dim, n_comp,
            block, n, student_t):
    rho_ref = out_refs[0] if len(out_refs) == 2 else None
    logq_ref = out_refs[-1]
    mask = pl.program_id(0) * block + jnp.arange(block) < n
    xs = [plgpu.load(x_ref.at[j], mask=mask, other=0.0) - c_ref[j]
          for j in range(dim)]

    def log_component(k):
        """log(w_k q_k(x)) for the block; -inf for a dead component."""
        maha = jnp.zeros((block,), jnp.float32)
        for a in range(dim):
            r = xs[0] * u_ref[k, a, 0] - b_ref[k, a]
            for j in range(1, a + 1):
                r = r + u_ref[k, a, j] * xs[j]
            maha = maha + r * r
        if student_t:
            return coef_ref[k, 0] - coef_ref[k, 1] * jnp.log1p(maha * coef_ref[k, 2])
        return coef_ref[k, 0] - 0.5 * maha

    def lse_step(k, carry):
        m, s = carry
        lw = log_component(k)
        # one exp per component: rescale the running sum only when the
        # maximum moves; a dead component (-inf) adds exactly nothing
        d = jnp.where(lw == -jnp.inf, -jnp.inf, lw - m)
        e = jnp.exp(-jnp.abs(d))
        return jnp.maximum(m, lw), jnp.where(d > 0, s * e + 1.0, s + e)

    m, s = jax.lax.fori_loop(
        0, n_comp, lse_step,
        (jnp.full((block,), -jnp.inf, jnp.float32),
         jnp.zeros((block,), jnp.float32)))
    logq = m + jnp.log(s)
    plgpu.store(logq_ref, logq, mask=mask)

    if rho_ref is not None:
        @pl.loop(0, n_comp)
        def _(k):
            dead = coef_ref[k, 0] == -jnp.inf
            rho_k = jnp.where(dead, 0.0, jnp.exp(log_component(k) - logq))
            plgpu.store(rho_ref.at[k], rho_k, mask=mask)


def _call(xT, center, u, b, coef, *, student_t, want_rho, interpret):
    dim, n = xT.shape
    n_comp = u.shape[0]
    block = _block_size(dim)

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)

    out_shape = [jax.ShapeDtypeStruct((n,), jnp.float32)]
    out_specs = [pl.BlockSpec((block,), lambda i: (i,))]
    if want_rho:
        out_shape.insert(0, jax.ShapeDtypeStruct((n_comp, n), jnp.float32))
        out_specs.insert(0, pl.BlockSpec((n_comp, block), lambda i: (0, i)))
    kernel = functools.partial(_kernel, dim=dim, n_comp=n_comp, block=block,
                               n=n, student_t=student_t)
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(pl.cdiv(n, block),),
        in_specs=[pl.BlockSpec((dim, block), lambda i: (0, i)),
                  whole(center), whole(u), whole(b), whole(coef)],
        out_specs=out_specs,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="mixture_rho" if want_rho else "mixture_logq",
    )(xT, center, u, b, coef)


def mixture_logq(xT, center, u, b, coef, *, student_t, interpret=False):
    """``log q (N,)`` of float32 particles ``xT (D, N)``.

    :param center: ``(D,)`` point subtracted from the particles first.
    :param u: ``(K, D, D)`` lower-triangular whitening ``L_k^{-1}``.
    :param b: ``(K, D)`` whitened component means ``U_k (mu_k - center)``.
    :param coef: ``(K, 3)``: ``log w_k + log_norm_k`` (``-inf`` for a dead
        component), then for Student-t ``(dof_k + D) / 2`` and ``1 / dof_k``.
    :param interpret: run in the Pallas interpreter (tests on the CPU).
    """
    (logq,) = _call(xT, center, u, b, coef, student_t=student_t,
                    want_rho=False, interpret=interpret)
    return logq


def mixture_rho(xT, center, u, b, coef, *, student_t, interpret=False):
    """Responsibilities ``rho (K, N) = w_k q_k(x) / q(x)`` and ``log q (N,)``;
    operands as in :func:`mixture_logq`."""
    rho, logq = _call(xT, center, u, b, coef, student_t=student_t,
                      want_rho=True, interpret=interpret)
    return rho, logq
