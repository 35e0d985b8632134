"""Matmul precision on the main path: every float32 ``dot_general`` that the
entry points trace asks for full float32 precision.

On the GPU a float32 product that names no precision may run in TF32, which
keeps about three decimal digits.  The CPU cannot show that rounding, so
this test traces each entry point in float32 (64-bit mode off, as on the
card) and records the precision of every ``dot_general`` bound on the way.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend.core.primitives import dot_general_p
from jax.lax import Precision

import pypmc_tpu as pt
from pypmc_tpu.density import core

F32 = np.float32


@pytest.fixture
def float32_dots(monkeypatch):
    """Trace afresh in float32 and collect ``(operand dtypes, precision)``
    of every dot_general."""
    seen = []
    bind = dot_general_p.bind

    def spy(*args, **params):
        seen.append((tuple(getattr(a, "dtype", None) for a in args),
                     params.get("precision")))
        return bind(*args, **params)

    jax.clear_caches()
    monkeypatch.setattr(dot_general_p, "bind", spy)
    with jax.enable_x64(False):
        yield seen
    jax.clear_caches()


def assert_full_precision(seen):
    assert seen, "the entry point traced no matmul"
    loose = [(dt, p) for dt, p in seen
             if jnp.float32 in dt
             and not (p is not None and all(q == Precision.HIGHEST for q in p))]
    assert not loose, "float32 dot_general without full precision: %s" % loose


def mixture(K=3, D=3, student_t=False, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 2, (K, D)).astype(F32)
    covs = np.array([np.eye(D, dtype=F32) * 1.5] * K)
    dofs = np.full(K, 6.0, F32) if student_t else None
    return core.make_mixture(means, covs, np.full(K, 1.0 / K, F32), dofs)[0]


def host_mixture(K=3, D=3, student_t=False):
    p = mixture(K, D, student_t)
    if student_t:
        return pt.density.create_t_mixture(np.asarray(p.means), np.asarray(p.cov),
                                           np.asarray(p.dof))
    return pt.density.create_gaussian_mixture(np.asarray(p.means), np.asarray(p.cov))


def test_propose_logq(float32_dots):
    core.propose_logq_T(mixture(student_t=True), jax.random.PRNGKey(0), 256,
                        mixture(2, seed=1))
    assert_full_precision(float32_dots)


def test_importance_sampler_run(float32_dots):
    t = mixture(2, seed=1)
    target = pt.sampler.batched_target(lambda xT: core.mixture_logpdf_T(t, xT),
                                       transposed=True)
    sampler = pt.sampler.ImportanceSampler(target, host_mixture(student_t=True),
                                           rng=0)
    sampler.run(256, to_host=False)
    assert_full_precision(float32_dots)


@pytest.mark.parametrize("student_t", [False, True])
def test_pmc_update(float32_dots, student_t):
    x = jax.random.normal(jax.random.PRNGKey(0), (3, 512), jnp.float32)
    w = jnp.ones((512,), jnp.float32)
    pt.mix_adapt.pmc.pmc_update(mixture(student_t=student_t), x, w,
                                transposed=True)
    assert_full_precision(float32_dots)


def test_gaussian_inference(float32_dots):
    data = jax.random.normal(jax.random.PRNGKey(0), (512, 3), jnp.float32)
    vb = pt.mix_adapt.variational.GaussianInference(data, components=3)
    vb.run(3, prune=0.0)
    assert_full_precision(float32_dots)


def test_sample_adaptive_chains(float32_dots):
    starts = np.zeros((8, 3), F32)
    pt.sampler.markov_chain.sample_adaptive_chains(
        mixture(), starts, np.eye(3, dtype=F32), 16, 2, key=jax.random.PRNGKey(1))
    assert_full_precision(float32_dots)


def test_adaptive_markov_chain(float32_dots):
    t = mixture()
    mc = pt.sampler.AdaptiveMarkovChain(
        lambda x: core.mixture_logpdf(t, x[None, :])[0],
        pt.density.LocalGauss(np.eye(3, dtype=F32)), np.zeros(3, F32), rng=0)
    mc.run(32)
    mc.adapt()
    assert_full_precision(float32_dots)


def test_hierarchical(float32_dots):
    f = host_mixture(K=6)
    g = host_mixture(K=2)
    pt.mix_adapt.hierarchical.Hierarchical(f, g).run(eps=1e-4, kill=False)
    assert_full_precision(float32_dots)


def test_combine_weights(float32_dots):
    props = [host_mixture(), host_mixture(K=2)]
    samples = [jax.random.normal(jax.random.PRNGKey(i), (128, 3), jnp.float32)
               for i in range(2)]
    weights = [jnp.ones((128,), jnp.float32)] * 2
    pt.sampler.combine_weights(samples, weights, props)
    assert_full_precision(float32_dots)


def test_pmc_run_sharded(float32_dots):
    pt.parallel.pmc_run_sharded(mixture(2, seed=1), mixture(student_t=True),
                                n_total=8 * 64, n_steps=2,
                                key=jax.random.PRNGKey(2))
    assert_full_precision(float32_dots)
