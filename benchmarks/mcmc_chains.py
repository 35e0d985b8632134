"""Adaptive-MCMC throughput: the vmapped chain pool vs a single chain.

The reference's acceptance workload #3 is adaptive Metropolis
(``examples/markov_chain.py``; hot loop ``sampler/markov_chain.py:100-165``,
one Python object per chain).  Here it is ONE ``lax.scan`` over the steps
carrying the whole chain pool (``sample_adaptive_chains``): a chain step is
inherently serial, so the device earns its keep on the CHAIN axis, not the
step axis.  This measures chains*steps/s for growing pool sizes, plus the
single-object host-driven ``AdaptiveMarkovChain`` baseline.

    python benchmarks/mcmc_chains.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


D = 10
N_STEPS = 500          # steps per adaptation cycle
N_CYCLES = 4


def make_target():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    a = rng.normal(0, 0.3, size=(D, D))
    cov = np.eye(D) + a @ a.T
    inv = np.linalg.inv(cov).astype(np.float32)
    inv_j = jnp.asarray(inv)

    def log_target(x):
        return -0.5 * x @ inv_j @ x

    return log_target, cov


def bench_pool(C):
    import jax
    from pypmc_tpu.sampler import sample_adaptive_chains

    log_target, cov = make_target()
    rng = np.random.default_rng(0)
    starts = rng.normal(0, 1, size=(C, D)).astype(np.float32)
    sigma0 = (np.eye(D, dtype=np.float32) * 2.38**2 / D)

    def run(key):
        return sample_adaptive_chains(
            log_target, starts, sigma0, n_steps=N_STEPS,
            n_adapt_cycles=N_CYCLES, key=key)

    samples, rates = run(jax.random.PRNGKey(0))     # compile
    float(np.asarray(rates).mean())
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        samples, rates = run(jax.random.PRNGKey(i + 1))
        r = float(np.asarray(rates).mean())         # forces full sync
        times.append(time.perf_counter() - t0)
    total_steps = C * N_STEPS * N_CYCLES
    return total_steps / min(times), r


def bench_single_host():
    """Reference-style single chain: one AdaptiveMarkovChain object,
    run/adapt cycles driven from the host."""
    from pypmc_tpu.density import LocalGauss
    from pypmc_tpu.sampler import AdaptiveMarkovChain

    log_target, _ = make_target()
    prop = LocalGauss(np.eye(D) * 2.38**2 / D)
    mc = AdaptiveMarkovChain(log_target, prop,
                             np.zeros(D, dtype=np.float32), rng=0)
    mc.run(64)  # warm up / compile
    t0 = time.perf_counter()
    for _ in range(N_CYCLES):
        mc.run(N_STEPS)
        mc.adapt()
    dt = time.perf_counter() - t0
    return N_STEPS * N_CYCLES / dt


if __name__ == "__main__":
    single = bench_single_host()
    print("single host-driven chain:        %10.0f steps/s" % single,
          flush=True)
    for C in (1, 64, 1024, 4096, 16384):
        sps, rate = bench_pool(C)
        print("pool C=%-5d %12.0f chain-steps/s  (%.0fx single; accept %.2f)"
              % (C, sps, sps / single, rate), flush=True)
