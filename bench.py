"""Benchmark: importance-sampling throughput (samples/s per GPU) on the
flagship workload -- a Student-t mixture proposal (K=10, D=10) evaluated
against a bimodal Gaussian-mixture target, the whole step
propose -> evaluate-proposal -> evaluate-target -> importance-weights.

Fails without a GPU.  Prints the card's name and power limit, then ONE JSON
line: {"metric", "value", "unit", "vs_baseline", "device", ...}.

Baseline: the reference (pypmc) cannot be built here (no Cython in the
image), so the baseline is a numpy CPU implementation of the same step with
per-component vectorized evaluation.  This is GENEROUS to the reference:
pypmc's actual IS weight path is a per-sample Python loop over Cython
single-point evaluates (``sampler/importance_sampling.py:197-215``), which is
strictly slower than the vectorized numpy used here -- so ``vs_baseline``
understates the true speedup over the reference.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

K = 10        # proposal mixture components
KT = 2        # target mixture components
D = 10        # dimension
N = 1 << 26   # particles per step
N_CPU = 1 << 16  # particles per step for the numpy baseline (extrapolated)
REPS = 10
TRIALS = 3    # independent timing loops; report the best trial median


def make_problem(dtype):
    rng = np.random.default_rng(0)
    means = rng.normal(0.0, 3.0, size=(K, D)).astype(dtype)
    a = rng.normal(0.0, 0.2, size=(K, D, D)).astype(dtype)
    covs = (np.eye(D, dtype=dtype)[None] * 1.5 + np.einsum("kij,klj->kil", a, a)).astype(dtype)
    dofs = np.full((K,), 8.0, dtype=dtype)
    weights = np.full((K,), 1.0 / K, dtype=dtype)
    # bimodal Gaussian-mixture target (the reference's flagship example shape)
    t_means = np.stack([rng.normal(0, 1, size=D), rng.normal(0, 1, size=D) + 3.0]).astype(dtype)
    t_covs = np.array([np.eye(D) * 0.8] * KT).astype(dtype)
    t_weights = np.array([0.3, 0.7], dtype=dtype)
    return means, covs, dofs, weights, t_means, t_covs, t_weights


# ------------------------------------------------------------------ #
# numpy CPU baseline (vectorized reference semantics)                 #
# ------------------------------------------------------------------ #

def numpy_baseline_sps():
    from scipy.special import gammaln

    means, covs, dofs, weights, t_means, t_covs, t_weights = make_problem(np.float64)
    chols = np.linalg.cholesky(covs)
    invs = np.linalg.inv(covs)
    _, logdets = np.linalg.slogdet(covs)
    log_norms = (
        gammaln(0.5 * (dofs + D)) - gammaln(0.5 * dofs)
        - 0.5 * D * np.log(dofs * np.pi) - 0.5 * logdets
    )
    t_invs = np.linalg.inv(t_covs)
    _, t_logdets = np.linalg.slogdet(t_covs)
    t_lognorms = -0.5 * D * np.log(2 * np.pi) - 0.5 * t_logdets
    rng = np.random.RandomState(1)

    def step(n):
        # propose: multinomial allocation + per-component transform
        counts = rng.multinomial(n, weights)
        blocks = []
        for k in range(K):
            if counts[k] == 0:
                continue
            z = rng.normal(0, 1, (counts[k], D))
            chi2 = rng.chisquare(dofs[k], counts[k])
            blocks.append(
                means[k] + z.dot(chols[k].T) * np.sqrt(dofs[k] / chi2)[:, None]
            )
        samples = np.vstack(blocks)
        rng.shuffle(samples)
        # proposal log-pdf: per-component vectorized evaluate + logsumexp
        logq_k = np.empty((n, K))
        for k in range(K):
            diff = samples - means[k]
            maha = np.einsum("ni,ij,nj->n", diff, invs[k], diff)
            logq_k[:, k] = log_norms[k] - 0.5 * (dofs[k] + D) * np.log1p(maha / dofs[k])
        m = logq_k.max(axis=1, keepdims=True)
        log_q = np.log(np.sum(weights * np.exp(logq_k - m), axis=1)) + m[:, 0]
        # mixture target log-pdf
        logp_k = np.empty((n, KT))
        for k in range(KT):
            diff = samples - t_means[k]
            maha = np.einsum("ni,ij,nj->n", diff, t_invs[k], diff)
            logp_k[:, k] = t_lognorms[k] - 0.5 * maha
        m = logp_k.max(axis=1, keepdims=True)
        log_p = np.log(np.sum(t_weights * np.exp(logp_k - m), axis=1)) + m[:, 0]
        return np.exp(log_p - log_q)

    step(1024)  # warm caches
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(N_CPU)
        times.append(time.perf_counter() - t0)
    return N_CPU / np.median(times)


# ------------------------------------------------------------------ #
# GPU measurement                                                     #
# ------------------------------------------------------------------ #

def gpu_samples_per_s():
    import jax
    import jax.numpy as jnp
    from pypmc_tpu.density import core

    means, covs, dofs, weights, t_means, t_covs, t_weights = make_problem(np.float32)
    params, valid = core.make_mixture(means, covs, weights, dofs)
    assert bool(np.asarray(valid).all())
    t_params, t_valid = core.make_mixture(t_means, t_covs, t_weights)
    assert bool(np.asarray(t_valid).all())

    @jax.jit
    def step(params, t_params, key):
        samples_T, latent, log_q, log_p = core.propose_logq_T(
            params, key, N, t_params)
        w = jnp.exp(log_p - log_q)
        # on-device diagnostics; only scalars leave the card
        return jnp.sum(w), jnp.sum(w * w)

    key = jax.random.PRNGKey(0)
    jax.block_until_ready(step(params, t_params, key))  # compile
    # TRIALS independent loops with fresh keys; report the best trial
    # median plus the spread across trials
    trial_sps = []
    for t in range(TRIALS):
        times = []
        for i in range(REPS):
            k = jax.random.fold_in(key, t * REPS + i)
            t0 = time.perf_counter()
            jax.block_until_ready(step(params, t_params, k))
            times.append(time.perf_counter() - t0)
        trial_sps.append(N / np.median(times))
    return max(trial_sps), trial_sps


def main():
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print("bench: no GPU found (platform %r)" % device.platform,
              file=sys.stderr)
        sys.exit(1)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       ".jax_cache"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print("card: %s" % card)
    cpu = numpy_baseline_sps()
    gpu, trials = gpu_samples_per_s()
    spread_pct = 100.0 * (max(trials) - min(trials)) / max(trials)
    print(json.dumps({
        "metric": "is_samples_per_s_per_gpu",
        "value": round(gpu, 1),
        "unit": "samples/s",
        "vs_baseline": round(gpu / cpu, 2),
        "trial_spread_pct": round(spread_pct, 1),
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
