"""Large-scale Student-t mixture PMC (BASELINE.md acceptance config 5):
10^7 particles per adaptation step, sharded over every available chip (and
every host when launched under ``jax.distributed``), with psum-reduced
sufficient statistics.

Single host (GPUs or a simulated CPU mesh):

    python examples/pmc_large_scale.py --particles 10000000 --steps 10

Multi-host slice: run one process per host with the usual coordinator
environment; `pypmc_tpu.parallel.distributed_initialize()` is called
automatically when JAX_COORDINATOR_ADDRESS is set.
"""

import argparse
import os
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=10_000_000)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--components", type=int, default=10)
    args = ap.parse_args()

    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        from pypmc_tpu.parallel import distributed_initialize

        # manual multi-process launches (examples/launch_2proc.py, the
        # mpirun -n 2 analog) pass the process topology via env; cluster
        # environments (SLURM/GKE) are auto-detected with both unset
        nproc = os.environ.get("JAX_NUM_PROCESSES")
        pid = os.environ.get("JAX_PROCESS_ID")
        distributed_initialize(
            num_processes=int(nproc) if nproc else None,
            process_id=int(pid) if pid else None)

    import jax
    import pypmc_tpu as pt
    from pypmc_tpu.density import core
    from pypmc_tpu.parallel import particle_mesh, pmc_run_sharded

    K, D = args.components, args.dim
    dtype = np.float64 if jax.default_backend() == "cpu" else np.float32
    rng = np.random.default_rng(0)

    # multimodal Gaussian-mixture target: two well-separated modes
    t_means = np.stack([rng.normal(0, 1, D), rng.normal(0, 1, D) + 3.0]).astype(dtype)
    t_covs = np.array([np.eye(D) * 0.8, np.eye(D) * 1.2]).astype(dtype)
    t_params, _ = core.make_mixture(t_means, t_covs, np.array([0.3, 0.7], dtype=dtype))

    # passing the target as MixtureParams lets pmc_run_sharded evaluate it
    # batched over each shard's particles; the equivalent callable form
    # would be:
    #   @batched_target(transposed=True)
    #   def log_target(xT): return core.mixture_logpdf_T(t_params, xT)
    log_target = t_params

    # wide Student-t proposal covering both modes
    means = rng.normal(1.5, 3.0, size=(K, D)).astype(dtype)
    covs = np.array([np.eye(D) * 6.0] * K).astype(dtype)
    dofs = np.full((K,), 8.0, dtype=dtype)
    params, _ = core.make_mixture(means, covs, None, dofs)

    mesh = particle_mesh()
    n_dev = mesh.devices.size
    n_total = (args.particles // n_dev) * n_dev
    print("mesh: %d device(s); %d particles per PMC step" % (n_dev, n_total))

    # compile once -- with the SAME step count as the timed run: the
    # multi-step driver jits the whole n-step scan, so a warmup with a
    # different n_steps warms a different executable and the timed region
    # would silently pay the compile; wait for it to finish before timing
    _, warm = pmc_run_sharded(log_target, params, n_total, args.steps,
                              mesh=mesh, key=jax.random.PRNGKey(0))
    np.asarray(warm.ess)

    # time a few repetitions with DISTINCT keys and report the median.  The
    # keys are the same on every process, so the adapted mixture stays
    # process-identical.
    per_step_ms = []
    for rep in range(3):
        t0 = time.perf_counter()
        params_out, stats = pmc_run_sharded(
            log_target, params, n_total, args.steps, mesh=mesh,
            key=jax.random.PRNGKey(1 + rep),
        )
        np.asarray(stats.ess)  # host sync
        per_step_ms.append((time.perf_counter() - t0) / args.steps * 1e3)
    params = params_out
    dt_ms = float(np.median(per_step_ms))

    print("perplexity per step:", np.round(np.asarray(stats.perplexity), 4))
    print("ESS per step:       ", np.round(np.asarray(stats.ess), 4))
    print("step time: %.1f ms (median of %d)  |  throughput: %.1f M samples/s (total)"
          % (dt_ms, len(per_step_ms), n_total / dt_ms / 1e3))

    w = np.asarray(params.weights)
    live = w > 0.01
    print("live components:", int(live.sum()),
          "| weight mass near mode A/B:",
          np.round([w[np.linalg.norm(np.asarray(params.means) - t_means[0], axis=1) < 3].sum(),
                    w[np.linalg.norm(np.asarray(params.means) - t_means[1], axis=1) < 3].sum()], 3))

    # every process must compute the IDENTICAL adapted mixture from the
    # psum'ed statistics (no proposal broadcast -- the property that
    # replaces the reference's rank-0 bcast, examples/pmc_mpi.py:128);
    # examples/launch_2proc.py compares this line across processes
    import hashlib

    h = hashlib.sha256()
    for arr in (params.means, params.cov, params.weights, params.dof):
        h.update(np.ascontiguousarray(np.asarray(arr)).tobytes())
    print("adapted digest: %s" % h.hexdigest()[:16])


if __name__ == "__main__":
    main()
