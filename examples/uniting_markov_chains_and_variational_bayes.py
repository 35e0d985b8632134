"""Full evidence-estimation pipeline (the reference's
``examples/uniting_markov_chains_and_variational_bayes.py`` workload):
integrate a normalized Student-t mixture with almost no analytical knowledge:

1. map out the regions of interest with ten adaptive Markov chains,
2. group mixed chains by Gelman-Rubin R and build a long-patches mixture,
3. fit the thinned MCMC samples with variational Bayes,
4. importance-sample, refine the proposal with a second (weighted) VB run
   seeded by the first posterior,
5. combine the two runs' weights deterministically [Cor+12] and estimate the
   integral (analytically 1) with its uncertainty, plus perplexity and ESS.
"""

import numpy as np
import pypmc_tpu as pt

dim = 2

# the target: a normalized Student-t mixture of three nearby components
mean0 = np.array([-6.0, 7.3])
covariance0 = np.array([[0.8, -0.3], [-0.3, 1.25]])
mean1 = np.array([-7.0, 8.0])
covariance1 = np.array([[0.5, 0.0], [0.0, 0.2]])
mean2 = np.array([-8.5, 7.5])
covariance2 = np.array([[0.5, 0.2], [0.2, 0.2]])

component_weights = np.array([0.3, 0.4, 0.3])
target_mixture = pt.density.create_t_mixture(
    [mean0, mean1, mean2], [covariance0, covariance1, covariance2],
    [13, 17, 5], component_weights,
)
log_target = target_mixture.evaluate_fn()

# ---- 1. Markov chains from random starts in [-10, 10]^2 ---- #
# All chains run IN PARALLEL on device: one vmapped scan kernel per
# adaptation cycle (the reference loops 10 per-chain Python objects,
# ``examples/uniting_markov_chains_and_variational_bayes.py:72-87``).
rng = np.random.default_rng(2024)
starts = rng.uniform(-10, 10, size=(10, dim))

print("running Markov chains ...")
import jax

pool_samples, accept_rates = pt.sampler.sample_adaptive_chains(
    log_target, starts, np.eye(dim) * 2.38**2 / dim,
    n_steps=500, n_adapt_cycles=20, key=jax.random.PRNGKey(2024),
)
# discard the first cycle as burn-in (the reference's mc.clear() after run 0)
mc_samples_sorted_by_chain = [np.asarray(c[500:]) for c in pool_samples]
mc_samples = np.vstack(mc_samples_sorted_by_chain)

# ---- 2. group chains by R value, build long-patches mixture ---- #
long_patches = pt.mix_adapt.make_r_gaussmix(mc_samples_sorted_by_chain, K_g=10)

# ---- 3. variational Bayes on thinned samples ---- #
print("running variational Bayes ...")
vb = pt.mix_adapt.GaussianInference(
    mc_samples[::100], initial_guess=long_patches, W0=np.eye(dim) * 1e10
)
vb_prune = 0.5 * len(vb.data) / vb.K
vb.run(1000, rel_tol=1e-8, abs_tol=1e-5, prune=vb_prune)
vbmix = vb.make_mixture()

# ---- 4. importance sampling + second (weighted) VB refinement ---- #
print("running importance sampling ...")
sampler = pt.sampler.ImportanceSampler(log_target, vbmix, rng=0)
sampler.run(1000)

prior_for_proposal_update = vb.posterior2prior()
prior_for_proposal_update.pop("alpha0")
vb2 = pt.mix_adapt.GaussianInference(
    sampler.samples[:],
    initial_guess=vbmix,
    weights=sampler.weights[:][:, 0],
    **prior_for_proposal_update,
)
print("running variational Bayes ...")
vb2.run(1000, rel_tol=1e-8, abs_tol=1e-5)
vb2mix = vb2.make_mixture()

sampler.proposal = vb2mix
print("running importance sampling ...")
sampler.run(10**4)

# ---- 5. combine the weights, estimate the integral ---- #
weights = pt.sampler.combine_weights(
    [s[:] for s in sampler.samples],
    [w[:][:, 0] for w in sampler.weights],
    [vbmix, vb2mix],
)[:][:, 0]
samples = sampler.samples[:]

integral_estimator = weights.sum() / len(weights)
integral_uncertainty_estimator = np.sqrt(
    (weights**2).sum() / len(weights) - integral_estimator**2
) / np.sqrt(len(weights) - 1)

print("analytical integral = 1")
print("estimated  integral =", integral_estimator, "+-", integral_uncertainty_estimator)
print("perplexity", float(pt.tools.perp(weights)))
print("effective sample size", float(pt.tools.ess(weights)))

try:
    import matplotlib.pyplot as plt

    plt.figure()
    plt.hist2d(samples[:, 0], samples[:, 1], weights=weights, bins=100, cmap="gray_r")
    mappable = pt.tools.plot_mixture(sampler.proposal, visualize_weights=True, cmap="jet")
    plt.colorbar(mappable, ax=plt.gca())
    plt.title("colors visualize component weights")
    plt.savefig("uniting_example.png", dpi=100)
    print("wrote uniting_example.png")
except ImportError:
    print('For plotting "matplotlib" needs to be installed')
