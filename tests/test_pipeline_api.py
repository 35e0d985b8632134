"""The one-call evidence API (`pypmc_tpu.pipeline.integrate`)."""

import numpy as np
import pytest

import pypmc_tpu as pt


def bimodal(dim):
    means = np.stack([np.zeros(dim), np.full(dim, 3.0)])
    covs = np.array([np.eye(dim) * 0.7] * 2)
    return pt.density.create_gaussian_mixture(means, covs, np.array([0.4, 0.6]))


def make_starts(dim, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return np.vstack([rng.normal(0, 1.5, (n // 2, dim)),
                      rng.normal(3, 1.5, (n // 2, dim))])


def test_integrate_mixture_target():
    """Mixture-target path: recovers the analytic evidence
    and returns a live Student-t proposal plus per-stage diagnostics."""
    dim = 3
    r = pt.pipeline.integrate(
        bimodal(dim), dim, make_starts(dim), mcmc_steps=200, mcmc_cycles=6,
        n_is1=1 << 14, n_is2=1 << 15, pmc_steps=5)
    assert abs(r.evidence - 1.0) < 0.03, r
    assert r.uncertainty < 0.03
    assert r.ess > 0.2
    assert r.n_samples == (1 << 14) + (1 << 15)
    assert len(r.proposal) >= 1
    assert r.samples.shape == (r.n_samples, dim)
    assert "mcmc_s" in r.details and "final_K" in r.details
    # the refinement curve is monotone-ish toward a usable proposal
    curve = r.details["pmc_perplexity_curve"]
    assert curve[-1] > curve[0] * 0.5


def test_integrate_callable_target():
    """Generic jittable log-density path (scan-pool MCMC + PMC driver)."""
    dim = 2
    fn = bimodal(dim).evaluate_fn()
    r = pt.pipeline.integrate(
        fn, dim, make_starts(dim), mcmc_steps=200, mcmc_cycles=5,
        n_is1=1 << 13, n_is2=1 << 14, pmc_steps=2)
    assert abs(r.evidence - 1.0) < 0.05, r


def test_integrate_validates_starts():
    dim = 3
    with pytest.raises(ValueError, match="starts"):
        pt.pipeline.integrate(bimodal(dim), dim, np.zeros((4, dim + 1)))
    # non-finite target at a start fails loudly inside the chain pool
    bad = np.full((4, dim), np.nan)
    with pytest.raises(ValueError):
        pt.pipeline.integrate(bimodal(dim), dim, bad)


def test_integrate_sharded_mesh():
    """mesh= runs both IS stages sharded (ParallelSampler), VB with
    psum'ed statistics, and the PMC refinement via pmc_run_sharded --
    same estimate within MC error."""
    from pypmc_tpu.parallel import particle_mesh

    dim = 3
    mesh = particle_mesh()
    r = pt.pipeline.integrate(
        bimodal(dim), dim, make_starts(dim), mesh=mesh,
        mcmc_steps=200, mcmc_cycles=6,
        n_is1=1 << 14, n_is2=1 << 15, pmc_steps=5)
    assert abs(r.evidence - 1.0) < 0.03, r
    assert r.ess > 0.2
    assert "pmc_perplexity_curve" in r.details


# resume tests require this process to write checkpoints: writes are
# process-0-gated (multi-process checkpointing is covered by the shared-dir
# scenario in test_distributed.py)
_writes_checkpoints = pytest.mark.single_process(
    reason="checkpoint writes are process-0-gated")


@_writes_checkpoints
def test_integrate_checkpoint_resume(tmp_path):
    """checkpoint_dir saves each completed stage; a re-run resumes from
    the furthest one (refined proposal -> only the final sampling stage
    runs), and a partial checkpoint resumes mid-pipeline."""
    import os

    dim = 3
    ck = str(tmp_path / "ck")
    kwargs = dict(mcmc_steps=200, mcmc_cycles=6, n_is1=1 << 14,
                  n_is2=1 << 15, pmc_steps=5, checkpoint_dir=ck)
    r1 = pt.pipeline.integrate(bimodal(dim), dim, make_starts(dim), **kwargs)
    assert r1.details["resumed_stages"] == []
    assert sorted(os.listdir(ck)) == [
        "mcmc.npz", "refined_mixture.npz", "vb1.npz", "vb1_mixture.npz"]

    r2 = pt.pipeline.integrate(bimodal(dim), dim, make_starts(dim), **kwargs)
    assert r2.details["resumed_stages"] == ["mcmc", "vb1", "refined"]
    assert abs(r2.evidence - 1.0) < 0.03
    assert r2.n_samples == 1 << 15  # final run only

    os.remove(os.path.join(ck, "refined_mixture.npz"))
    r3 = pt.pipeline.integrate(bimodal(dim), dim, make_starts(dim), **kwargs)
    assert r3.details["resumed_stages"] == ["mcmc", "vb1"]
    assert abs(r3.evidence - 1.0) < 0.03


def test_integrate_return_samples_false():
    """Evidence-only mode: no host materialization of the samples."""
    dim = 2
    r = pt.pipeline.integrate(
        bimodal(dim), dim, make_starts(dim), mcmc_steps=200, mcmc_cycles=5,
        n_is1=1 << 13, n_is2=1 << 14, pmc_steps=3, return_samples=False)
    assert r.samples is None
    assert abs(r.evidence - 1.0) < 0.05
    assert r.n_samples == (1 << 13) + (1 << 14)


@_writes_checkpoints
def test_integrate_mesh_checkpoint_resume(tmp_path):
    """mesh= combined with checkpoint_dir= (the round-4 verdict's untested
    combination): the sharded pipeline writes stage checkpoints and a
    re-run resumes from the refined proposal, re-running only the final
    sharded sampling stage."""
    import os

    from pypmc_tpu.parallel import particle_mesh

    dim = 3
    mesh = particle_mesh()
    ck = str(tmp_path / "ck")
    kwargs = dict(mesh=mesh, mcmc_steps=200, mcmc_cycles=6, n_is1=1 << 14,
                  n_is2=1 << 15, pmc_steps=5, checkpoint_dir=ck)
    r1 = pt.pipeline.integrate(bimodal(dim), dim, make_starts(dim), **kwargs)
    assert r1.details["resumed_stages"] == []
    assert sorted(os.listdir(ck)) == [
        "mcmc.npz", "refined_mixture.npz", "vb1.npz", "vb1_mixture.npz"]
    assert abs(r1.evidence - 1.0) < 0.03, r1

    r2 = pt.pipeline.integrate(bimodal(dim), dim, make_starts(dim), **kwargs)
    assert r2.details["resumed_stages"] == ["mcmc", "vb1", "refined"]
    assert abs(r2.evidence - 1.0) < 0.03, r2
    assert r2.n_samples == 1 << 15  # final sharded run only

    # mid-pipeline resume under the mesh: drop the refined proposal, keep VB1
    os.remove(os.path.join(ck, "refined_mixture.npz"))
    r3 = pt.pipeline.integrate(bimodal(dim), dim, make_starts(dim), **kwargs)
    assert r3.details["resumed_stages"] == ["mcmc", "vb1"]
    assert abs(r3.evidence - 1.0) < 0.03, r3


@_writes_checkpoints
def test_integrate_checkpoint_config_mismatch(tmp_path):
    """A checkpoint written under different pipeline kwargs must be
    rejected loudly, not silently combined with the current schedule."""
    dim = 3
    ck = str(tmp_path / "ck")
    pt.pipeline.integrate(bimodal(dim), dim, make_starts(dim),
                          mcmc_steps=200, mcmc_cycles=5, n_is1=1 << 13,
                          n_is2=1 << 14, pmc_steps=2, checkpoint_dir=ck)
    import os
    os.remove(os.path.join(ck, "refined_mixture.npz"))
    os.remove(os.path.join(ck, "vb1.npz"))
    os.remove(os.path.join(ck, "vb1_mixture.npz"))
    with pytest.raises(ValueError, match="different pipeline configuration"):
        pt.pipeline.integrate(bimodal(dim), dim, make_starts(dim),
                              mcmc_steps=400, mcmc_cycles=5, n_is1=1 << 13,
                              n_is2=1 << 14, pmc_steps=2, checkpoint_dir=ck)


def test_pmc_run_sharded_weight_clip():
    """weight_clip=True adapts on truncated weights (Ionides 2008) under
    the sharded runner; the adapted mixture stays live and close to the
    unclipped run on a benign target."""
    import jax
    from pypmc_tpu.density import core
    from pypmc_tpu.parallel import particle_mesh, pmc_run_sharded

    rng = np.random.default_rng(0)
    D, K = 2, 3
    means = rng.normal(0, 2, (K, D))
    covs = np.array([np.eye(D) * 1.5] * K)
    params, _ = core.make_mixture(means, covs, None, np.full(K, 8.0))
    tm, tc = np.zeros((1, D)), np.array([np.eye(D)])
    tparams, _ = core.make_mixture(tm, tc, np.array([1.0]))
    mesh = particle_mesh()
    p1, s1 = pmc_run_sharded(tparams, params, 1 << 13, 3, mesh=mesh,
                             key=jax.random.PRNGKey(0), weight_clip=True)
    p0, s0 = pmc_run_sharded(tparams, params, 1 << 13, 3, mesh=mesh,
                             key=jax.random.PRNGKey(0), weight_clip=False)
    assert (np.asarray(p1.weights) > 0).any()
    # benign target: clipping barely bites, results agree loosely
    np.testing.assert_allclose(np.asarray(p1.means), np.asarray(p0.means),
                               atol=0.3)
    assert np.asarray(s1.ess)[-1] > 0.3
