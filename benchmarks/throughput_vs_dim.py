"""Propose+eval throughput across problem dimensions (perf surface).

The headline bench pins D=10; this sweeps D for the same Student-t
IS step (K=10 proposal, 2-component Gaussian target).  The particle count
is N = min(2^26, budget/D) with budget = 10 * 2^26 elements: rows with
D >= 10 share the same N*D traffic; rows below D=10 are capped at the
N=2^26 batch (smaller N*D -- their per-element figures are still in the
dispatch-amortized regime at ~130+ ms/step, but compare the <=D=5 rows to
each other, not to the fixed-budget ones).

    python benchmarks/throughput_vs_dim.py [--dims 2 5 10 20 40]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K, KT = 10, 2
BUDGET = 10 * (1 << 26)  # N*D elements (the headline config's budget)
REPS = 7


def one_dim(D):
    import jax
    import jax.numpy as jnp
    from pypmc_tpu.density import core

    N = min(1 << 26, int(BUDGET // D))
    N = (N // 1024) * 1024
    rng = np.random.default_rng(0)
    dt = np.float32
    means = rng.normal(0, 3, (K, D)).astype(dt)
    a = rng.normal(0, 0.2, (K, D, D)).astype(dt)
    covs = np.eye(D, dtype=dt)[None] * 1.5 + np.einsum("kij,klj->kil", a, a)
    params, _ = core.make_mixture(means, covs, None, np.full(K, 8.0, dt))
    t_means = np.stack([rng.normal(0, 1, D), rng.normal(0, 1, D) + 3.0]).astype(dt)
    t_covs = np.array([np.eye(D) * 0.8] * KT).astype(dt)
    tparams, _ = core.make_mixture(t_means, t_covs, np.array([0.3, 0.7], dt))

    @jax.jit
    def step(params, tparams, key):
        out = core.propose_logq_T(params, key, N, tparams)
        return jnp.sum(out[2]), jnp.sum(out[3])

    key = jax.random.PRNGKey(0)
    jax.tree.map(float, step(params, tparams, key))
    times = []
    for i in range(REPS):
        k = jax.random.fold_in(key, i + 1)
        t0 = time.perf_counter()
        jax.tree.map(float, step(params, tparams, k))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print("D=%2d: N=%d  %.1f ms  %.2f ns/sample  %.1fM samples/s  "
          "%.2f ns/(sample*dim)"
          % (D, N, med * 1e3, med / N * 1e9, N / med / 1e6, med / N / D * 1e9),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, nargs="+", default=[2, 5, 10, 20, 40])
    args = ap.parse_args()
    for D in args.dims:
        one_dim(D)


if __name__ == "__main__":
    main()
