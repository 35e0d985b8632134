"""Full PMC training-step benchmark (BASELINE.md north-star: "IS samples/s
+ proposal-adaptation step time").

One step = propose -> proposal log-q -> target log-q -> weights ->
Rao-Blackwellized responsibilities -> psum-ready sufficient statistics ->
masked component update (+ Student-t gamma pass and dof bisection).

    python benchmarks/pmc_step.py [--particles 4194304] [--steps 6]
"""

import argparse
import json
import time

import numpy as np

import os
import sys

# allow running directly via `python benchmarks/<script>.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=1 << 22)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--components", type=int, default=10)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()

    import jax
    from pypmc_tpu.density import core
    from pypmc_tpu.mix_adapt.pmc import pmc_step_mixture_target

    K, D, N = args.components, args.dim, args.particles
    dtype = np.float64 if jax.default_backend() == "cpu" else np.float32
    rng = np.random.default_rng(0)
    means = rng.normal(0, 3, size=(K, D)).astype(dtype)
    a = rng.normal(0, 0.2, size=(K, D, D)).astype(dtype)
    covs = (np.eye(D, dtype=dtype)[None] * 1.5 + np.einsum("kij,klj->kil", a, a)).astype(dtype)
    dofs = np.full((K,), 8.0, dtype=dtype)

    t_means = np.stack([rng.normal(0, 1, D), rng.normal(0, 1, D) + 3.0]).astype(dtype)
    t_covs = np.array([np.eye(D) * 0.8] * 2).astype(dtype)
    t_params, _ = core.make_mixture(t_means, t_covs, np.array([0.3, 0.7], dtype=dtype))

    def make_step(student_t):
        @jax.jit
        def step(params, key):
            result, _, _, _, _ = pmc_step_mixture_target(
                params, t_params, key, N,
                dof_solver_steps=100 if student_t else 0,
            )
            return result.params

        return step

    out = {}
    for name, student_t in [("gaussian", False), ("student_t", True)]:
        params, _ = core.make_mixture(
            means, covs, None, dofs if student_t else None
        )
        step = make_step(student_t)
        params = step(params, jax.random.PRNGKey(0))
        jax.block_until_ready(params)
        ts = []
        for i in range(args.steps):
            k = jax.random.fold_in(jax.random.PRNGKey(1), i)
            t0 = time.perf_counter()
            jax.block_until_ready(step(params, k))
            ts.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(ts))
        out[name] = {"step_ms": round(med, 1),
                     "samples_per_s": round(N / med * 1e3)}
        print(name, out[name], flush=True)

    print(json.dumps({"pmc_step": out, "particles": N, "K": K, "D": D}))


if __name__ == "__main__":
    main()
