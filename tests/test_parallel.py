"""Tests for the device-mesh parallel layer on the virtual 8-device CPU
mesh (conftest forces ``--xla_force_host_platform_device_count=8``).

The key invariance (SURVEY.md section 7 "hard parts"): the sharded PMC
update with psum'ed sufficient statistics must produce EXACTLY the same
mixture as the single-device update on the concatenated particle set."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from functools import partial
from jax.sharding import PartitionSpec as P

from pypmc_tpu.density import create_gaussian_mixture, create_t_mixture
from pypmc_tpu.density import core
from pypmc_tpu.mix_adapt.pmc import pmc_log_likelihood, pmc_update
from pypmc_tpu.parallel import (
    ParallelSampler,
    particle_mesh,
    pmc_run_sharded,
    run_is_step_sharded,
)

MEANS = np.array([[1.0, -1.0], [2.0, 3.0], [-3.0, 0.5]])
COVS = np.array(
    [
        [[1.3, 0.7], [0.7, 1.5]],
        [[0.5, 0.0], [0.0, 0.5]],
        [[2.0, -0.4], [-0.4, 1.0]],
    ]
)
WEIGHTS = np.array([0.5, 0.3, 0.2])
DOFS = np.array([5.0, 9.0, 30.0])

TARGET_MU = np.array([0.0, 1.0])
TARGET_INV = np.linalg.inv(np.array([[2.0, 0.3], [0.3, 1.0]]))


def log_target(x):
    diff = x - jnp.asarray(TARGET_MU)
    return -0.5 * diff @ jnp.asarray(TARGET_INV) @ diff


def test_eight_devices_available():
    assert len(jax.devices()) == 8


class TestShardedInvariance:
    """Sharded psum update == single-device update on the same particles."""

    @pytest.mark.parametrize("student_t", [False, True])
    def test_pmc_update_sharded_equals_serial(self, student_t):
        mesh = particle_mesh()
        n = 8 * 50
        rng = np.random.default_rng(0)
        samples = rng.normal(size=(n, 2))
        weights = np.abs(rng.normal(1.0, 0.2, size=n))
        if student_t:
            params, _ = core.make_mixture(MEANS, COVS, WEIGHTS, DOFS)
        else:
            params, _ = core.make_mixture(MEANS, COVS, WEIGHTS)

        serial = pmc_update(params, jnp.asarray(samples), jnp.asarray(weights))

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(), P("particles"), P("particles")),
                 out_specs=P())
        def sharded(params, samples, weights):
            res = pmc_update(params, samples, weights, axis_name="particles")
            return res.params

        sharded_params = jax.jit(sharded)(
            params, jnp.asarray(samples), jnp.asarray(weights)
        )

        assert np.allclose(np.asarray(serial.params.weights),
                           np.asarray(sharded_params.weights), atol=1e-12)
        assert np.allclose(np.asarray(serial.params.means),
                           np.asarray(sharded_params.means), atol=1e-12)
        assert np.allclose(np.asarray(serial.params.cov),
                           np.asarray(sharded_params.cov), atol=1e-12)
        if student_t:
            assert np.allclose(np.asarray(serial.params.dof),
                               np.asarray(sharded_params.dof), atol=1e-9)

    def test_log_likelihood_sharded_equals_serial(self):
        mesh = particle_mesh()
        n = 8 * 25
        rng = np.random.default_rng(1)
        samples = rng.normal(size=(n, 2))
        params, _ = core.make_mixture(MEANS, COVS, WEIGHTS)
        serial = float(pmc_log_likelihood(params, jnp.asarray(samples)))

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(), P("particles")), out_specs=P())
        def sharded(params, samples):
            return pmc_log_likelihood(params, samples, axis_name="particles")

        assert np.isclose(float(jax.jit(sharded)(params, jnp.asarray(samples))),
                          serial, atol=1e-12)


class TestShardedSampling:
    @pytest.mark.single_process(reason="inspects raw particle-sharded shards on host")
    def test_run_is_step_sharded_shapes_and_weights(self):
        mesh = particle_mesh()
        mix = create_gaussian_mixture(MEANS, COVS, WEIGHTS)
        params = mix.stacked_params()
        samples_T, weights, latent = run_is_step_sharded(
            params, log_target, jax.random.PRNGKey(0), 8 * 100, mesh
        )
        assert samples_T.shape == (2, 800)  # transposed device layout
        assert weights.shape == (800,)
        # weights consistent with a recomputation on the host
        samples = np.asarray(samples_T).T
        log_q = np.asarray(core.mixture_logpdf(params, samples))
        log_p = np.asarray(jax.vmap(log_target)(jnp.asarray(samples)))
        assert np.allclose(np.asarray(weights), np.exp(log_p - log_q), rtol=1e-10)

    @pytest.mark.single_process(reason="inspects raw particle-sharded shards on host")
    def test_devices_produce_distinct_samples(self):
        mesh = particle_mesh()
        mix = create_gaussian_mixture(MEANS, COVS, WEIGHTS)
        samples_T, _, _ = run_is_step_sharded(
            mix.stacked_params(), log_target, jax.random.PRNGKey(0), 8 * 10, mesh
        )
        shards = np.split(np.asarray(samples_T).T, 8)
        for i in range(7):
            assert not np.allclose(shards[i], shards[i + 1])


class TestPMCRunSharded:
    @pytest.mark.parametrize("student_t", [False, True])
    def test_full_pmc_loop_adapts_to_target(self, student_t):
        mesh = particle_mesh()
        means0 = [np.array([-2.0, 0.0]), np.array([2.0, 2.0])]
        covs0 = [np.eye(2) * 4.0] * 2
        if student_t:
            params, _ = core.make_mixture(
                np.array(means0), np.array(covs0), None, np.array([10.0, 10.0])
            )
        else:
            params, _ = core.make_mixture(np.array(means0), np.array(covs0))
        params, stats = pmc_run_sharded(
            log_target, params, n_total=8 * 500, n_steps=8, mesh=mesh,
            key=jax.random.PRNGKey(1),
        )
        # perplexity improves as the proposal adapts to the unimodal target
        perp = np.asarray(stats.perplexity)
        assert perp[-1] > 0.8
        assert perp[-1] > perp[0]
        # the live components' means converge to the target mean
        w = np.asarray(params.weights)
        mu = np.asarray(params.means)
        est = (w[:, None] * mu).sum(axis=0)
        assert np.allclose(est, TARGET_MU, atol=0.3)

    def test_stats_fields(self):
        params, _ = core.make_mixture(MEANS, COVS, WEIGHTS)
        params, stats = pmc_run_sharded(
            log_target, params, n_total=8 * 100, n_steps=3,
            key=jax.random.PRNGKey(5),
        )
        assert stats.perplexity.shape == (3,)
        assert stats.ess.shape == (3,)
        assert np.all(np.asarray(stats.ess) > 0)
        assert np.all(np.isfinite(np.asarray(stats.log_likelihood)))


class TestParallelSampler:
    def test_run_and_history(self):
        mix = create_t_mixture(MEANS, COVS, DOFS, WEIGHTS)
        ps = ParallelSampler(log_target, mix, rng=3)
        assert ps.n_devices == 8
        ps.run(100)
        assert ps.samples[:].shape == (800, 2)
        assert len(ps.samples_list) == 8
        assert all(len(s) == 100 for s in ps.samples_list)
        ps.run(50)
        assert ps.samples[:].shape == (1200, 2)
        ps.clear()
        assert len(ps.samples) == 0

    def test_device_resident_mode(self):
        """run(to_host=False) keeps samples/weights SHARDED on device: the
        host Histories stay empty, evidence_stats reduces on device, and a
        later gather() produces exactly what direct host runs would have
        (VERDICT r3: the MPISampler-analog API must not pay the O(N*D)
        device->host transfer unconditionally)."""
        import jax

        mix = create_t_mixture(MEANS, COVS, DOFS, WEIGHTS)
        ps = ParallelSampler(log_target, mix, rng=3)
        ps.run(100, to_host=False)
        ps.run(50, to_host=False)
        assert len(ps.samples) == 0 and len(ps.weights) == 0
        assert len(ps.device_runs) == 2
        sT, w = ps.device_runs[0]
        assert isinstance(sT, jax.Array) and sT.shape == (2, 800)
        # sharded over the full mesh, not host-committed
        assert len(sT.sharding.device_set) == 8
        sum_w, sum_w2, n = ps.evidence_stats()
        assert n == 1200
        assert np.isclose(sum_w, float(w.sum()) + float(ps.device_runs[1][1].sum()))
        # gather defers the host transfer until asked
        assert ps.gather() == 2
        assert ps.samples[:].shape == (1200, 2)
        assert len(ps.device_runs) == 0
        # identical to a host-mode sampler with the same seed
        ps2 = ParallelSampler(log_target, mix, rng=3)
        ps2.run(100)
        ps2.run(50)
        np.testing.assert_allclose(ps.samples[:], ps2.samples[:])
        np.testing.assert_allclose(ps.weights[:], ps2.weights[:])
        s1, w1, n1 = ps.evidence_stats()
        s2, w2_, n2 = ps2.evidence_stats()
        assert n1 == n2 and np.isclose(s1, s2) and np.isclose(w1, w2_)

    def test_moment_recovery(self):
        prop = create_gaussian_mixture(
            [TARGET_MU], [np.eye(2) * 3.0]
        )
        ps = ParallelSampler(log_target, prop, rng=8)
        ps.run(20000)
        samples = ps.samples[:]
        w = ps.weights[:][:, 0]
        mean = (w[:, None] * samples).sum(axis=0) / w.sum()
        assert np.allclose(mean, TARGET_MU, atol=0.05)


class TestShardedVB:
    def test_vb_sharded_data_matches_unsharded(self):
        """With the data's particle axis sharded over the mesh, the jitted
        VB E/M steps auto-reduce the sufficient statistics across devices
        (GSPMD); the bound and posterior must match the unsharded run."""
        from jax.sharding import NamedSharding
        from pypmc_tpu.mix_adapt import GaussianInference
        from pypmc_tpu.parallel.mesh import particle_mesh, particle_sharding

        rng = np.random.default_rng(0)
        data = np.vstack([rng.normal(0, 1, (40, 2)), rng.normal(5, 1, (40, 2))])
        w = np.abs(rng.normal(1, 0.2, size=80))

        vb_plain = GaussianInference(data, components=4, weights=w)
        vb_plain.run(iterations=10, prune=0.0)

        mesh = particle_mesh()
        sharding = particle_sharding(mesh)
        data_s = jax.device_put(jnp.asarray(data), sharding)
        w_s = jax.device_put(jnp.asarray(w), sharding)
        vb_sharded = GaussianInference(data_s, components=4, weights=w_s)
        vb_sharded.run(iterations=10, prune=0.0)

        assert np.isclose(
            vb_plain.likelihood_bound(), vb_sharded.likelihood_bound(), rtol=1e-12
        )
        assert np.allclose(np.asarray(vb_plain.m), np.asarray(vb_sharded.m), atol=1e-12)
        assert np.allclose(np.asarray(vb_plain.N_comp), np.asarray(vb_sharded.N_comp),
                           atol=1e-10)


class TestScanSteps:
    def test_scan_steps_adapts_like_loop(self):
        params, _ = core.make_mixture(
            np.array([[-2.0, 0.0], [2.0, 2.0]]), np.array([np.eye(2) * 4.0] * 2)
        )
        p_scan, stats = pmc_run_sharded(
            log_target, params, n_total=8 * 400, n_steps=6,
            key=jax.random.PRNGKey(3), scan_steps=True,
        )
        assert stats.perplexity.shape == (6,)
        perp = np.asarray(stats.perplexity)
        assert np.all(np.isfinite(perp))
        assert perp[-1] > perp[0]
        w = np.asarray(p_scan.weights)
        mu = np.asarray(p_scan.means)
        est = (w[:, None] * mu).sum(axis=0)
        assert np.allclose(est, TARGET_MU, atol=0.3)


class TestMixtureTarget:
    """A MixtureParams target and the same mixture as a batched callable
    share the same key-derived sample stream, so the runs must agree
    EXACTLY -- this pins the target-as-argument
    plumbing (cache token, shard_map specs) and the sw-based diagnostics."""

    def _targets(self):
        t_means = np.array([[0.0, 1.0], [2.0, -1.0]])
        t_covs = np.array([np.eye(2) * 1.5, np.eye(2) * 0.7])
        t_weights = np.array([0.4, 0.6])
        t_params, valid = core.make_mixture(t_means, t_covs, t_weights)
        assert bool(np.asarray(valid).all())

        def t_callable(xT):
            return core.mixture_logpdf_T(t_params, xT)

        from pypmc_tpu.sampler import batched_target

        return t_params, batched_target(t_callable, transposed=True)

    @pytest.mark.parametrize("student_t", [False, True])
    def test_mixture_target_equals_callable_target(self, student_t):
        t_params, t_callable = self._targets()
        if student_t:
            params, _ = core.make_mixture(MEANS, COVS, WEIGHTS, DOFS)
        else:
            params, _ = core.make_mixture(MEANS, COVS, WEIGHTS)

        p_mix, stats_mix = pmc_run_sharded(
            t_params, params, n_total=8 * 300, n_steps=3,
            key=jax.random.PRNGKey(11),
        )
        p_call, stats_call = pmc_run_sharded(
            t_callable, params, n_total=8 * 300, n_steps=3,
            key=jax.random.PRNGKey(11),
        )
        assert np.allclose(np.asarray(p_mix.means), np.asarray(p_call.means),
                           rtol=1e-6, atol=1e-9)
        assert np.allclose(np.asarray(p_mix.weights), np.asarray(p_call.weights),
                           rtol=1e-6, atol=1e-12)
        for f in stats_mix._fields:
            assert np.allclose(np.asarray(getattr(stats_mix, f)),
                               np.asarray(getattr(stats_call, f)),
                               rtol=1e-5), f

    def test_mixture_target_cache_not_stale(self):
        """Two different target parameter values must give different
        results through the cached compiled step (regression for baking
        target params in as closure constants)."""
        t_params, _ = self._targets()
        t2_means = np.asarray(t_params.means) + 2.5
        t2_params, _ = core.make_mixture(
            t2_means, np.asarray(t_params.cov), np.asarray(t_params.weights))
        params, _ = core.make_mixture(MEANS, COVS, WEIGHTS)

        p1, _ = pmc_run_sharded(t_params, params, n_total=8 * 200, n_steps=2,
                                key=jax.random.PRNGKey(5))
        p2, _ = pmc_run_sharded(t2_params, params, n_total=8 * 200, n_steps=2,
                                key=jax.random.PRNGKey(5))
        assert not np.allclose(np.asarray(p1.means), np.asarray(p2.means),
                               atol=0.1)

    def test_step_mixture_target_matches_manual(self):
        """pmc_step_mixture_target == manual propose_logq_T + pmc_update
        composition with the same key."""
        from pypmc_tpu.mix_adapt.pmc import pmc_step_mixture_target

        t_params, _ = self._targets()
        params, _ = core.make_mixture(MEANS, COVS, WEIGHTS, DOFS)
        key = jax.random.PRNGKey(7)
        n = 1500

        result, samples_T, w, latent, sw = pmc_step_mixture_target(
            params, t_params, key, n)

        s2, l2, logq, logp = core.propose_logq_T(params, key, n, t_params)
        w2 = jnp.exp(logp - logq)
        ref = pmc_update(params, s2, w2, transposed=True, dof_solver_steps=100)

        assert np.allclose(np.asarray(samples_T), np.asarray(s2))
        assert np.allclose(np.asarray(result.params.means),
                           np.asarray(ref.params.means), rtol=1e-6)
        assert np.allclose(np.asarray(result.params.cov),
                           np.asarray(ref.params.cov), rtol=1e-6)
        assert np.allclose(np.asarray(result.params.dof),
                           np.asarray(ref.params.dof), rtol=1e-6)
        assert np.isclose(float(sw[0]), float(jnp.sum(w2)), rtol=1e-6)
        assert np.isclose(float(sw[1]), float(jnp.sum(w2 * w2)), rtol=1e-6)


class TestShardedFusedVB:
    """GaussianInference with ``mesh=``: the particle axis is sharded over
    the mesh and GSPMD reduces the E-step's sums across devices; the run
    must reproduce the plain single-device run."""

    def test_sharded_fused_estep_matches_plain(self):
        from pypmc_tpu.mix_adapt import variational as vb

        n, dd = 8 * 200, 3
        rng = np.random.default_rng(5)
        data = np.vstack([rng.normal(-2, 0.5, size=(n // 2, dd)),
                          rng.normal(2, 0.5, size=(n // 2, dd))]).astype(np.float32)

        plain = vb.GaussianInference(data, components=3,
                                     nu=np.full(3, dd + 1.0))
        plain.run(30, prune=0.0)

        mesh = particle_mesh()
        sharded = vb.GaussianInference(data, components=3,
                                       nu=np.full(3, dd + 1.0), mesh=mesh)
        assert sharded.data.sharding.spec == P("particles", None)
        sharded.run(30, prune=0.0)

        assert np.allclose(np.asarray(sharded.N_comp), np.asarray(plain.N_comp),
                           rtol=5e-3, atol=5e-2)
        assert np.allclose(np.asarray(sharded.m), np.asarray(plain.m),
                           rtol=5e-3, atol=5e-3)
        assert np.isclose(sharded.likelihood_bound(), plain.likelihood_bound(),
                          rtol=1e-4)


class TestShardedFusedPMC:
    """pmc_update INSIDE shard_map on the 8-device mesh, the composition the
    sharded PMC runner uses: psum'ed sufficient statistics must reproduce
    the serial update."""

    @pytest.mark.parametrize("K,D", [(3, 2), (80, 2), (21, 10)])
    def test_fused_sharded_equals_serial(self, K, D):
        rng = np.random.default_rng(11)
        means = rng.normal(0, 3, size=(K, D)).astype(np.float32)
        covs = np.array([np.eye(D, dtype=np.float32) * 1.5] * K)
        params, valid = core.make_mixture(means, covs)
        assert bool(np.asarray(valid).all())
        n = 8 * 1024
        samples = jnp.asarray(rng.normal(0, 3, size=(n, D)).astype(np.float32))
        weights = jnp.asarray(
            np.abs(rng.normal(1, 0.2, size=n)).astype(np.float32))

        serial = pmc_update(params, samples, weights)
        mesh = particle_mesh()

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(), P("particles"), P("particles")),
                 out_specs=P(), check_vma=False)
        def sharded(p, s, wts):
            return pmc_update(p, s, wts, axis_name="particles").params

        out = jax.jit(sharded)(params, samples, weights)
        # float32 sums over 8 shards in another order than the serial sum
        np.testing.assert_allclose(np.asarray(out.weights),
                                   np.asarray(serial.params.weights),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(out.means),
                                   np.asarray(serial.params.means),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(np.asarray(out.cov),
                                   np.asarray(serial.params.cov),
                                   rtol=5e-3, atol=5e-3)


class TestNonDivisibleN:
    """N not divisible by the device count: the samplers round up (extra
    draws), VB pads with zero-weight samples (exactly no contribution) --
    the reference's MPI layer accepts any N, so must the mesh layer."""

    @pytest.mark.single_process(reason="inspects raw particle-sharded shards on host")
    def test_run_is_step_rounds_up(self):
        mix = create_gaussian_mixture(MEANS, COVS, WEIGHTS)
        params = mix.stacked_params()
        mesh = particle_mesh()
        n_dev = mesh.devices.size
        samples_T, weights, latent = run_is_step_sharded(
            params, log_target, jax.random.PRNGKey(0), n_total=n_dev * 10 + 3,
            mesh=mesh)
        n_drawn = samples_T.shape[1]
        assert n_drawn == n_dev * 11  # rounded up to the next multiple
        assert weights.shape == (n_drawn,)
        assert np.isfinite(np.asarray(weights)).all()

    def test_pmc_run_sharded_rounds_up(self):
        mix = create_gaussian_mixture(MEANS, COVS, WEIGHTS)
        params = mix.stacked_params()
        out_params, stats = pmc_run_sharded(
            log_target, params, n_total=8 * 64 + 5, n_steps=2,
            key=jax.random.PRNGKey(1))
        assert np.isfinite(np.asarray(stats.ess)).all()
        assert np.isfinite(np.asarray(out_params.means)).all()

    def test_pmc_run_sharded_non_rb(self):
        """rb=False (one-hot responsibilities from the latent draw) through
        the sharded runner -- the latent indices must reach pmc_update
        (regression: they were dropped, crashing the non-RB path)."""
        mix = create_gaussian_mixture(MEANS, COVS, WEIGHTS)
        params = mix.stacked_params()
        out_params, stats = pmc_run_sharded(
            log_target, params, n_total=8 * 256, n_steps=3, rb=False,
            key=jax.random.PRNGKey(2))
        assert np.isfinite(np.asarray(stats.ess)).all()
        assert np.isfinite(np.asarray(out_params.means)).all()
        assert (np.asarray(out_params.weights) >= 0).all()
        # the non-RB update still adapts toward the target
        assert float(np.asarray(stats.ess)[-1]) > \
            float(np.asarray(stats.ess)[0]) - 0.05

    def test_vb_mesh_pads_with_zero_weight(self):
        from pypmc_tpu.mix_adapt import variational as vb

        n, dd = 8 * 150 + 7, 2   # NOT divisible by 8
        rng = np.random.default_rng(9)
        data = np.vstack([rng.normal(-2, 0.5, size=(600, dd)),
                          rng.normal(2, 0.5, size=(n - 600, dd))]).astype(np.float32)

        plain = vb.GaussianInference(data, components=2,
                                     nu=np.full(2, dd + 1.0))
        plain.run(20, prune=0.0)

        sharded = vb.GaussianInference(data, components=2,
                                       nu=np.full(2, dd + 1.0),
                                       mesh=particle_mesh())
        assert sharded.N == n
        assert sharded.weights.shape[0] == 8 * 151  # padded
        assert float(jnp.sum(sharded.weights[n:])) == 0.0
        assert sharded.r.shape == (n, 2)
        sharded.run(20, prune=0.0)
        assert np.allclose(np.asarray(sharded.N_comp), np.asarray(plain.N_comp),
                           rtol=5e-3, atol=5e-2)
        assert np.isclose(sharded.likelihood_bound(), plain.likelihood_bound(),
                          rtol=1e-4)
