"""Adaptive Metropolis sampling (the reference's ``examples/markov_chain.py``
workload): a local Student-t proposal adapts its covariance to a narrow
correlated 2-D Gaussian target; the chain steps run as one compiled
``lax.scan`` per run.
"""

import numpy as np
import jax.numpy as jnp
import pypmc_tpu as pt

# define a proposal
prop_dof = 1.0
prop_sigma = np.array([[0.1, 0.0], [0.0, 0.02]])
prop = pt.density.LocalStudentT(prop_sigma, prop_dof)

# define the target: log of an unnormalized Gaussian density
target_sigma = np.array([[0.01, 0.003], [0.003, 0.0025]])
inv_target_sigma = jnp.asarray(np.linalg.inv(target_sigma))
target_mean = jnp.asarray(np.array([4.3, 1.1]))


def log_target(x):
    diff = x - target_mean
    return -0.5 * diff @ inv_target_sigma @ diff


# choose a bad initialization
start = np.array([-2.0, 10.0])

mc = pt.sampler.AdaptiveMarkovChain(log_target, prop, start, rng=0)

# run burn-in and discard it
mc.run(10**4)
mc.clear()

# run 100,000 steps adapting the proposal every 500 steps
accept_count = 0
for i in range(200):
    accept_count += mc.run(500)
    mc.adapt()

values = mc.samples[:]
accept_rate = float(accept_count) / len(values)
print("The chain accepted %4.2f%% of the proposed points" % (accept_rate * 100))
print("sample mean:", values.mean(axis=0), " (target:", np.asarray(target_mean), ")")
print("sample cov:\n", np.cov(values, rowvar=0), "\n(target:\n", target_sigma, ")")

try:
    import matplotlib.pyplot as plt

    plt.hexbin(values[:, 0], values[:, 1], gridsize=40, cmap="gray_r")
    plt.savefig("markov_chain_example.png", dpi=100)
    print("wrote markov_chain_example.png")
except ImportError:
    print('For plotting "matplotlib" needs to be installed')
