"""VB-GMM update benchmark: one full variational update (E-step + M-step +
likelihood bound) on weighted samples -- the workload of the reference's
``GaussianInference.run`` inner loop (``mix_adapt/variational.pyx:283-359``),
which dominates the MCMC->VB->IS evidence pipeline at large N.

    python benchmarks/vb_step.py [--particles 4194304] [--reps 6]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=1 << 22)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--components", type=int, default=10)
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from pypmc_tpu.mix_adapt import variational as vb

    K, D, N = args.components, args.dim, args.particles
    dtype = np.float64 if jax.default_backend() == "cpu" else np.float32
    rng = np.random.default_rng(0)

    centers = rng.normal(0, 4, size=(K, D)).astype(dtype)
    lab = rng.integers(0, K, size=N)
    data = (centers[lab] + rng.normal(0, 1, size=(N, D))).astype(dtype)
    weights = np.abs(rng.normal(1, 0.2, size=N)).astype(dtype)

    vi = vb.GaussianInference(jnp.asarray(data), components=K,
                              weights=jnp.asarray(weights),
                              nu=np.full(K, D + 1.0))

    # warmup: compile the combined M+E+bound dispatch (what run() uses)
    vi._update_with_bound()

    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        b = vi._update_with_bound()  # float() inside forces the host sync
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))

    out = {
        "vb_update_ms": round(dt * 1e3, 1),
        "samples_per_s": int(N / dt),
        "particles": N, "K": K, "D": D,
        "final_bound": b,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
