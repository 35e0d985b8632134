"""Weak-scaling harness for the sharded Student-t PMC step
(BASELINE.md north-star: >=90% weak-scaling efficiency on the 10^7-particle
Student-t PMC across hosts).

Measures one full PMC step (propose -> weights -> psum'ed update) at a fixed
per-device particle count while growing the mesh 1, 2, 4, ... devices, and
reports throughput and efficiency vs the 1-device run.

On a multi-host slice, run one process per host after
``pypmc_tpu.parallel.distributed_initialize()``.  On a single CPU host,
simulate a mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=. python benchmarks/weak_scaling.py --per-device 65536
"""

import argparse
import json
import time

import numpy as np

import os
import sys

# allow running directly via `python benchmarks/<script>.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def comm_volume_bytes(K, D, n_total, dtype_bytes=4, student_t=True,
                      log_likelihood=True):
    """Exact per-step all-reduce payload of the sharded PMC step (floats
    psum'ed in ``pmc_update``/``run_is_step_sharded``), vs the reference's
    gather-to-rank-0 volume (samples + weights,
    ``tools/parallel_sampler.py:61-66``)."""
    # s0, s0c (K,) each; sd (K, D); g (K, D, D); dof t1 (K,);
    # weight normalization (1); diagnostics sum_w, sum_w2, sum_wlogw, n (4)
    floats = 2 * K + K * D + K * D * D + 1 + 4
    if student_t:
        floats += K          # t1 (dof-condition statistic)
    if log_likelihood:
        floats += 1          # psum'ed eq.(5) bound
    ref_gather = n_total * (D + 1) * 8   # float64 samples + weights
    return dict(psum_bytes_per_step=floats * dtype_bytes,
                reference_gather_bytes_per_step=ref_gather,
                ratio=ref_gather / (floats * dtype_bytes))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=1 << 20,
                    help="particles per device per step")
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--components", type=int, default=10)
    ap.add_argument("--steps", type=int, default=5, help="timed steps per size")
    ap.add_argument("--compare-scan", action="store_true",
                    help="also time scan_steps=True (whole run in one "
                         "compiled scan, no per-step host round-trip) vs "
                         "the host-loop mode")
    args = ap.parse_args()

    import jax
    import pypmc_tpu as pt
    from pypmc_tpu.density import core
    from pypmc_tpu.parallel import particle_mesh, pmc_run_sharded

    K, D = args.components, args.dim
    rng = np.random.default_rng(0)
    dtype = np.float64 if jax.default_backend() == "cpu" else np.float32
    means = rng.normal(0, 3, size=(K, D)).astype(dtype)
    a = rng.normal(0, 0.2, size=(K, D, D)).astype(dtype)
    covs = (np.eye(D, dtype=dtype)[None] * 1.5 + np.einsum("kij,klj->kil", a, a)).astype(dtype)
    dofs = np.full((K,), 8.0, dtype=dtype)
    params0, _ = core.make_mixture(means, covs, None, dofs)

    t_means = np.stack([rng.normal(0, 1, D), rng.normal(0, 1, D) + 3.0]).astype(dtype)
    t_covs = np.array([np.eye(D) * 0.8] * 2).astype(dtype)
    t_params, _ = core.make_mixture(t_means, t_covs, np.array([0.3, 0.7], dtype=dtype))

    from pypmc_tpu.sampler import batched_target

    @batched_target(transposed=True)
    def log_target(xT):
        return core.mixture_logpdf_T(t_params, xT)

    all_devices = jax.devices()
    sizes = []
    n = 1
    while n <= len(all_devices):
        sizes.append(n)
        n *= 2

    def time_psum_payload(mesh, n_dev, reps=30):
        """Measured wall time of JUST the per-step collective: psum the
        exact O(K D^2) sufficient-statistic payload over this mesh.
        Separates the collective from local compute so the weak-scaling
        deficit is a measured split, not byte accounting."""
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        payload = (jnp.zeros((K,), dtype), jnp.zeros((K,), dtype),
                   jnp.zeros((K, D), dtype), jnp.zeros((K, D, D), dtype),
                   jnp.zeros((K,), dtype), jnp.zeros((6,), dtype))

        @jax.jit
        @partial(jax.shard_map, mesh=mesh, in_specs=(P(),) * 6,
                 out_specs=(P(),) * 6, check_vma=False)
        def allreduce(*stats):
            return tuple(jax.lax.psum(s, "particles") for s in stats)

        jax.block_until_ready(allreduce(*payload))
        t0 = time.perf_counter()
        for _ in range(reps):
            payload = allreduce(*payload)
        jax.block_until_ready(payload)
        return (time.perf_counter() - t0) / reps * 1e3

    from functools import partial

    results = []
    base_sps = None
    base_ms = None
    for n_dev in sizes:
        mesh = particle_mesh(all_devices[:n_dev])
        n_total = args.per_device * n_dev
        # warmup (compile)
        pmc_run_sharded(log_target, params0, n_total, 1, mesh=mesh,
                        key=jax.random.PRNGKey(0))
        t0 = time.perf_counter()
        pmc_run_sharded(log_target, params0, n_total, args.steps, mesh=mesh,
                        key=jax.random.PRNGKey(1))
        dt = (time.perf_counter() - t0) / args.steps
        sps = n_total / dt
        if base_sps is None:
            base_sps = sps
            base_ms = dt * 1e3
        eff = sps / (base_sps * n_dev)
        # phase split: local compute = the 1-device step on the same
        # per-device particle count; collective = measured psum of the
        # real statistic payload; residual = scheduling/contention
        psum_ms = time_psum_payload(mesh, n_dev) if n_dev > 1 else 0.0
        residual_ms = dt * 1e3 - base_ms - psum_ms
        results.append(dict(devices=n_dev, particles=n_total,
                            step_ms=round(dt * 1e3, 2),
                            local_compute_ms=round(base_ms, 2),
                            psum_ms=round(psum_ms, 3),
                            residual_ms=round(residual_ms, 2),
                            samples_per_s=round(sps),
                            weak_scaling_efficiency=round(eff, 3)))
        print(json.dumps(results[-1]), flush=True)

    print(json.dumps({"weak_scaling": results}))
    print(json.dumps({"comm_volume": comm_volume_bytes(
        K, D, args.per_device * sizes[-1])}))

    if args.compare_scan:
        # per-step host round-trip (loop mode) vs one compiled lax.scan over
        # all steps: quantifies the dispatch/sync overhead the scan mode
        # removes.
        mesh = particle_mesh(all_devices[: sizes[-1]])
        n_total = args.per_device * sizes[-1]
        out = {}
        for scan in (False, True):
            # warm up with the SAME step count: n_steps is a static arg of
            # the compiled scan, so a different count recompiles
            pmc_run_sharded(log_target, params0, n_total, args.steps,
                            mesh=mesh, key=jax.random.PRNGKey(0),
                            scan_steps=scan)
            t0 = time.perf_counter()
            pmc_run_sharded(log_target, params0, n_total, args.steps,
                            mesh=mesh, key=jax.random.PRNGKey(1),
                            scan_steps=scan)
            out["scan" if scan else "loop"] = round(
                (time.perf_counter() - t0) / args.steps * 1e3, 2)
        print(json.dumps({"ms_per_step": out, "devices": sizes[-1],
                          "steps": args.steps}))


if __name__ == "__main__":
    main()
