"""Device-mesh parallel PMC (the replacement for the reference's
``examples/pmc_mpi.py``): the same bimodal-target PMC workload, but with the
particle axis sharded over ALL available devices and the sufficient
statistics all-reduced with psum -- no gather-to-rank-0, no proposal
broadcast.

Run on a multi-GPU host directly, or simulate N devices on CPU:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/pmc_sharded.py
"""

import numpy as np
import jax

import pypmc_tpu as pt
from pypmc_tpu.density import core
from pypmc_tpu.parallel import particle_mesh, pmc_run_sharded

# bimodal Gaussian target (same as examples/pmc.py)
component_weights = np.array([0.3, 0.7])
mean0 = np.array([5.0, 0.01])
covariance0 = np.array([[0.01, 0.003], [0.003, 0.0025]])
mean1 = np.array([-4.0, 1.0])
covariance1 = np.array([[0.1, 0.0], [0.0, 0.02]])

target_mixture = pt.density.create_gaussian_mixture(
    [mean0, mean1], [covariance0, covariance1], component_weights
)
# passing the target's stacked MixtureParams (instead of a callable,
# e.g. ``target_mixture.evaluate_fn()``) lets pmc_run_sharded evaluate it
# batched over each shard's particles
log_target = target_mixture.stacked_params()

# poor initial proposal: three wide components
initial_proposal = pt.density.create_gaussian_mixture(
    [np.array([4.0, 0.0]), np.array([-5.0, 0.0]), np.array([0.0, 0.0])],
    [np.eye(2)] * 3,
)
params = initial_proposal.stacked_params()

mesh = particle_mesh()
n_dev = mesh.devices.size
n_total = n_dev * (1000 // n_dev + 1) * n_dev  # ~1000 per step, divisible
print("mesh: %d device(s); %d particles per PMC step" % (n_dev, n_total))

params, stats = pmc_run_sharded(
    log_target, params, n_total=n_total, n_steps=10, mesh=mesh,
    key=jax.random.PRNGKey(0),
)

print("perplexity per step:", np.round(np.asarray(stats.perplexity), 3))
print("ESS per step:       ", np.round(np.asarray(stats.ess), 3))
print()

adapted = pt.density.MixtureDensity.from_params(params)
print("final component weights:", np.round(adapted.weights, 3))
print("target component weights:", component_weights)
for k in np.flatnonzero(adapted.weights > 0.05):
    print("component %d mean:" % k, np.round(adapted.components[k].mu, 3))
