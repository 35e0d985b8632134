"""Smoke test of the main path on one GPU: every phase at a real size.

    python chip_smoke.py               # phases 0-5 on one card
    python chip_smoke.py --four-cards  # the particle-sharded path on 4 cards

Phases (each one fails the run if it fails; none falls back to the CPU):

0. the device: a GPU, with the card's name and power limit printed;
1. the fused log-density kernel (``pypmc_tpu.ops.mixture_kernel``), compiled
   for the card at four (K, D) widths and compared with a float64 numpy
   reference on a subsample;
2. the importance-sampling step (``ImportanceSampler.run``,
   ``propose_logq_T``) at N=2^24, K=10, D=10, Student-t proposal, bimodal
   target;
3. sharded PMC (``pmc_run_sharded``) on a 1-card mesh, 10^7 particles;
4. the adaptive-MCMC chain pool (``sample_adaptive_chains``) and variational
   Bayes (``GaussianInference``);
5. the whole job, ``pipeline.integrate`` at D=20, against its analytic
   evidence of 1.

The last line of standard output is one JSON object with ``"ok": true`` and
the device as JAX reports it.  Times printed on the way are labelled with
the card and are not benchmark results.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
from scipy.linalg import solve_triangular
from scipy.special import gammaln

ROOT = Path(__file__).resolve().parent

# Tolerances against the float64 reference.  The kernel works in float32
# and accumulates D (D + 1) / 2 products per component, so the error of
# log q grows with its magnitude: |d log q| <= 1e-4 (1 + |log q|).  A
# responsibility is exp(log(w_k q_k) - log q); its error is bounded by the
# same exponent error times rho <= 1, hence |d rho| <= 2e-4 (1 + |log q|).
LOGQ_RTOL = 1e-4
RHO_RTOL = 2e-4
KERNEL_SHAPES = [(10, 10, True), (2, 10, False), (400, 2, False), (64, 40, True)]

# Sizes of the phases: the real widths and batch sizes of the workloads.
N_KERNEL = 1 << 24      # particles for log q
N_RHO = 1 << 22         # particles for rho: (K, N) at K=400 is 6.7 GB
N_REF = 1 << 16         # subsample compared with the float64 reference
N_IS = 1 << 24
N_PMC = 10_000_000
N_CHAINS = 16384
N_VB = 1 << 22


def log(msg):
    print(msg, flush=True)


def card_line():
    """The card's name and power limit, read by a child that does not use
    JAX (so only this process holds the card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def use_compile_cache():
    """Honour JAX_COMPILATION_CACHE_DIR; otherwise keep the cache at a fixed
    path inside the checkout, so a later run finds it again."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(ROOT / ".jax_cache"))


# ------------------------------------------------------------------ #
# float64 numpy reference                                             #
# ------------------------------------------------------------------ #

def numpy_logq_rho(params, xT):
    """``log q (N,)`` and ``rho (K, N)`` in float64 from the mixture's own
    parameters (Cholesky solves, no shared code with the library)."""
    means = np.asarray(params.means, np.float64)
    chol = np.asarray(params.chol, np.float64)
    w = np.asarray(params.weights, np.float64)
    dof = None if params.dof is None else np.asarray(params.dof, np.float64)
    x = np.asarray(xT, np.float64)
    K, D = means.shape
    lw = np.full((K, x.shape[1]), -np.inf)
    for k in range(K):
        if w[k] <= 0:
            continue
        z = solve_triangular(chol[k], x - means[k][:, None], lower=True)
        maha = np.sum(z * z, axis=0)
        half_log_det = np.sum(np.log(np.diag(chol[k])))
        if dof is None:
            lk = -0.5 * D * np.log(2 * np.pi) - half_log_det - 0.5 * maha
        else:
            nu = dof[k]
            lk = (gammaln(0.5 * (nu + D)) - gammaln(0.5 * nu)
                  - 0.5 * D * np.log(nu * np.pi) - half_log_det
                  - 0.5 * (nu + D) * np.log1p(maha / nu))
        lw[k] = np.log(w[k]) + lk
    m = lw.max(axis=0)
    logq = m + np.log(np.sum(np.exp(lw - m), axis=0))
    return logq, np.exp(lw - logq)


def random_mixture(K, D, student_t, seed=0, dtype=np.float32):
    """A random well-conditioned mixture with one dead component."""
    from pypmc_tpu.density import core

    rng = np.random.default_rng(seed)
    means = rng.normal(0, 2, (K, D))
    a = rng.normal(0, 0.3 / np.sqrt(D), (K, D, D))
    covs = np.eye(D)[None] * rng.uniform(0.5, 1.5, (K, 1, 1)) \
        + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    w[K // 2] = 0.0
    dofs = rng.uniform(4, 12, K) if student_t else None
    params, valid = core.make_mixture(
        means.astype(dtype), covs.astype(dtype), w.astype(dtype),
        None if dofs is None else dofs.astype(dtype))
    assert bool(np.asarray(valid).all())
    return params


def kernel_in_step(fn, *args):
    """Whether the jitted ``fn`` lowers to a step holding a Triton kernel."""
    return "triton" in fn.lower(*args).as_text()


def check_kernel(n=None, n_rho=None, n_ref=None, shapes=None):
    """Card-only check: run the fused kernel through the library's own
    dispatch at each (K, D) and compare a subsample with
    :func:`numpy_logq_rho`.  Returns ``[(K, D, err_logq, err_rho)]`` with
    errors in units of the stated tolerances (<= 1 passes)."""
    import jax
    import jax.numpy as jnp
    from pypmc_tpu.density import core
    from pypmc_tpu.mix_adapt.pmc import calculate_rho_rb_T
    from pypmc_tpu.ops import mixture_kernel

    n, n_rho, n_ref = n or N_KERNEL, n_rho or N_RHO, n_ref or N_REF
    results = []
    for K, D, student_t in shapes or KERNEL_SHAPES:
        params = random_mixture(K, D, student_t)
        xT = core.propose_T(params, jax.random.PRNGKey(K * 1000 + D), n)[0]
        xT = xT + 0.5 * jax.random.normal(jax.random.PRNGKey(1), xT.shape,
                                          xT.dtype)
        for arr in (xT, xT[:, :n_rho]):
            if not mixture_kernel.use_kernel(arr):
                raise AssertionError("kernel path not chosen for %s %s"
                                     % (arr.shape, arr.dtype))
        logq_fn = jax.jit(core.mixture_logpdf_T)
        rho_fn = jax.jit(calculate_rho_rb_T)
        for fn, arr in ((logq_fn, xT), (rho_fn, xT[:, :n_rho])):
            if not kernel_in_step(fn, params, arr):
                raise AssertionError("no Triton kernel in the compiled step")
        t0 = time.perf_counter()
        logq = jax.block_until_ready(logq_fn(params, xT))
        rho = jax.block_until_ready(rho_fn(params, xT[:, :n_rho]))
        dt = time.perf_counter() - t0
        ref_q, ref_rho = numpy_logq_rho(params, np.asarray(xT[:, :n_ref]))
        got_q = np.asarray(logq[:n_ref], np.float64)
        got_rho = np.asarray(rho[:, :n_ref], np.float64)
        if not bool(jnp.all(jnp.isfinite(logq)) & jnp.all(jnp.isfinite(rho))):
            raise AssertionError("non-finite kernel output at K=%d D=%d" % (K, D))
        err_q = np.max(np.abs(got_q - ref_q) / (LOGQ_RTOL * (1 + np.abs(ref_q))))
        err_rho = np.max(np.abs(got_rho - ref_rho)
                         / (RHO_RTOL * (1 + np.abs(ref_q))[None, :]))
        dead = K // 2
        if np.any(np.asarray(rho[dead]) != 0.0):
            raise AssertionError("dead component has nonzero rho")
        log("  K=%-3d D=%-2d %-8s path=kernel  |dlogq|/tol=%.3f  |drho|/tol=%.3f"
            "  max|dlogq|=%.3g  (first call incl. compile %.1f s)"
            % (K, D, "student-t" if student_t else "gauss", err_q, err_rho,
               np.max(np.abs(got_q - ref_q)), dt))
        results.append((K, D, float(err_q), float(err_rho)))
        del xT, logq, rho
    return results


def bench_problem(dtype=np.float32):
    """bench.py's problem: Student-t proposal K=10, D=10; bimodal target."""
    from pypmc_tpu.density import core

    K, D = 10, 10
    rng = np.random.default_rng(0)
    means = rng.normal(0.0, 3.0, size=(K, D))
    a = rng.normal(0.0, 0.2, size=(K, D, D))
    covs = np.eye(D)[None] * 1.5 + np.einsum("kij,klj->kil", a, a)
    t_means = np.stack([rng.normal(0, 1, size=D), rng.normal(0, 1, size=D) + 3.0])
    t_covs = np.array([np.eye(D) * 0.8] * 2)
    params, _ = core.make_mixture(means.astype(dtype), covs.astype(dtype),
                                  np.full(K, 0.1, dtype), np.full(K, 8.0, dtype))
    t_params, _ = core.make_mixture(t_means.astype(dtype), t_covs.astype(dtype),
                                    np.array([0.3, 0.7], dtype))
    return params, t_params


# ------------------------------------------------------------------ #
# phases                                                              #
# ------------------------------------------------------------------ #

def phase_kernel(card):
    check = check_kernel()
    bad = [r for r in check if not (r[2] <= 1.0 and r[3] <= 1.0)]
    if bad:
        raise AssertionError("kernel outside tolerance: %s" % bad)

    import jax
    from pypmc_tpu.density import core

    params, t_params = bench_problem()
    step = jax.jit(lambda p, tp, k: core.propose_logq_T(p, k, N_IS, tp))
    compiled = step.lower(params, t_params, jax.random.PRNGKey(0)).compile()
    log("  IS step memory_analysis (%s): %s" % (card, compiled.memory_analysis()))


def phase_is_step(card):
    import jax
    import jax.numpy as jnp
    import pypmc_tpu as pt
    from pypmc_tpu.density import core
    from pypmc_tpu.sampler import batched_target

    n = N_IS
    params, t_params = bench_problem()

    @batched_target(transposed=True)
    def log_target(xT):
        return core.mixture_logpdf_T(t_params, xT)

    proposal = pt.density.create_t_mixture(
        np.asarray(params.means), np.asarray(params.cov),
        np.asarray(params.dof), np.asarray(params.weights))
    sampler = pt.sampler.ImportanceSampler(log_target, proposal, rng=3)
    t0 = time.perf_counter()
    sampler.run(n, to_host=False)
    samples_T, weights = sampler.device_runs[-1]
    weights = np.asarray(weights, np.float64)
    dt = time.perf_counter() - t0
    if samples_T.shape != (10, n) or not np.isfinite(weights).all():
        raise AssertionError("ImportanceSampler.run: bad shape or weights")
    ess = weights.sum() ** 2 / (weights ** 2).sum() / n
    log("  ImportanceSampler.run N=%d: normalized ESS %.4f (%.1f s incl. compile, %s)"
        % (n, ess, dt, card))
    if not ess > 0:
        raise AssertionError("ESS not positive")

    xT, latent, log_q, log_p = core.propose_logq_T(
        params, jax.random.PRNGKey(5), n, t_params)
    w = jnp.exp(log_p - log_q)
    if not bool(jnp.all(jnp.isfinite(w))):
        raise AssertionError("propose_logq_T: non-finite weights")
    n_ref = N_REF
    ref_q, _ = numpy_logq_rho(params, np.asarray(xT[:, :n_ref]))
    ref_p, _ = numpy_logq_rho(t_params, np.asarray(xT[:, :n_ref]))
    err_q = np.max(np.abs(np.asarray(log_q[:n_ref]) - ref_q)
                   / (LOGQ_RTOL * (1 + np.abs(ref_q))))
    err_p = np.max(np.abs(np.asarray(log_p[:n_ref]) - ref_p)
                   / (LOGQ_RTOL * (1 + np.abs(ref_p))))
    log("  propose_logq_T N=%d: |dlogq|/tol=%.3f  |dlogp|/tol=%.3f" % (n, err_q, err_p))
    if err_q > 1 or err_p > 1:
        raise AssertionError("log q / log p outside tolerance")


def pmc_large_scale_problem(dtype=np.float32):
    """examples/pmc_large_scale.py's problem."""
    from pypmc_tpu.density import core

    K, D = 10, 10
    rng = np.random.default_rng(0)
    t_means = np.stack([rng.normal(0, 1, D), rng.normal(0, 1, D) + 3.0]).astype(dtype)
    t_covs = np.array([np.eye(D) * 0.8, np.eye(D) * 1.2]).astype(dtype)
    t_params, _ = core.make_mixture(t_means, t_covs, np.array([0.3, 0.7], dtype))
    means = rng.normal(1.5, 3.0, size=(K, D)).astype(dtype)
    covs = np.array([np.eye(D) * 6.0] * K).astype(dtype)
    params, _ = core.make_mixture(means, covs, None, np.full((K,), 8.0, dtype))
    return params, t_params, t_means


def mode_mass(params, t_means):
    w = np.asarray(params.weights)
    mu = np.asarray(params.means)
    return np.array([w[np.linalg.norm(mu - m, axis=1) < 3].sum() for m in t_means])


def phase_pmc_sharded(card, devices=None, n_total=None):
    import jax
    from pypmc_tpu.parallel import particle_mesh, pmc_run_sharded

    n_total = n_total or N_PMC
    params, t_params, t_means = pmc_large_scale_problem()
    mesh = particle_mesh(devices)
    t0 = time.perf_counter()
    out, stats = pmc_run_sharded(t_params, params, n_total, 5, mesh=mesh,
                                 key=jax.random.PRNGKey(1))
    mass = mode_mass(out, t_means)
    dt = time.perf_counter() - t0
    log("  pmc_run_sharded %d devices, %d particles, 5 steps: perplexity %s, "
        "mass near modes %s (%.1f s incl. compile, %s)"
        % (mesh.devices.size, n_total, np.round(np.asarray(stats.perplexity), 4),
           np.round(mass, 4), dt, card))
    if not np.all(np.abs(mass - [0.3, 0.7]) <= 0.05):
        raise AssertionError("mode mass %s not within 0.05 of [0.3, 0.7]" % mass)


def phase_chains_vb(card):
    import jax
    from pypmc_tpu.density import core
    from pypmc_tpu.mix_adapt.variational import GaussianInference
    from pypmc_tpu.sampler.markov_chain import sample_adaptive_chains

    C, D = N_CHAINS, 10
    target = random_mixture(4, D, False, seed=3)
    starts = core.propose(target, jax.random.PRNGKey(2), C)[0]
    t0 = time.perf_counter()
    samples, rates = sample_adaptive_chains(
        target, starts, np.eye(D, dtype=np.float32) * 0.1, 100, 3,
        key=jax.random.PRNGKey(4))
    rates = np.asarray(rates)
    dt = time.perf_counter() - t0
    log("  sample_adaptive_chains C=%d D=%d 3x100 steps: mean acceptance per "
        "cycle %s (%.1f s incl. compile, %s)"
        % (C, D, np.round(rates.mean(axis=0), 4), dt, card))
    if samples.shape != (C, 300, D) or not np.isfinite(np.asarray(samples)).all():
        raise AssertionError("chain pool: bad shape or non-finite samples")
    if not (np.isfinite(rates).all() and (rates >= 0).all() and (rates <= 1).all()
            and 0 < rates.mean() < 1):
        raise AssertionError("acceptance rates outside (0, 1)")

    n, K = N_VB, 10
    data_mix = random_mixture(K, D, False, seed=5)
    data = core.propose(data_mix, jax.random.PRNGKey(6), n)[0]
    t0 = time.perf_counter()
    vb = GaussianInference(data, components=K, initial_guess="first")
    bounds = [vb.likelihood_bound()]
    for _ in range(5):
        vb.update()
        bounds.append(vb.likelihood_bound())
    dt = time.perf_counter() - t0
    log("  GaussianInference N=%d K=%d D=%d, 5 steps: bounds %s (%.1f s incl. compile, %s)"
        % (n, K, D, ["%.6g" % b for b in bounds], dt, card))
    # float32 sums over 4 M samples: the bound may wobble by a few ulp
    for a, b in zip(bounds, bounds[1:]):
        if not b >= a - 1e-6 * abs(a):
            raise AssertionError("VB bound decreased: %s" % bounds)


def evidence_problem(dim=20, chains=16):
    """examples/integrate_evidence.py's target and chain starts."""
    import pypmc_tpu as pt

    rng = np.random.default_rng(7)
    direction = rng.normal(size=dim)
    direction /= np.linalg.norm(direction)
    means = np.stack([np.zeros(dim), 6.0 * direction])
    covs = []
    for _ in range(2):
        a = rng.normal(0, 0.15 / np.sqrt(dim), size=(dim, dim))
        covs.append(np.eye(dim) * rng.uniform(0.5, 1.0) + a @ a.T)
    target = pt.density.create_gaussian_mixture(
        means, np.array(covs), np.array([0.35, 0.65]))
    which = rng.integers(0, 2, chains)
    starts = np.stack([rng.multivariate_normal(means[k], 4.0 * np.array(covs)[k])
                       for k in which])
    return target, starts


def phase_integrate(card, mesh=None):
    import jax
    import pypmc_tpu as pt

    dim = 20
    target, starts = evidence_problem(dim)
    t0 = time.perf_counter()
    result = pt.pipeline.integrate(
        target, dim, starts, key=jax.random.PRNGKey(2024), mesh=mesh,
        mcmc_steps=300, mcmc_cycles=12, n_is1=1 << 16, n_is2=1 << 18)
    dt = time.perf_counter() - t0
    log("  integrate D=%d%s: evidence %.5f +- %.5f (analytic 1), perplexity %.3f, "
        "K=%d (%.1f s incl. compile, %s)"
        % (dim, "" if mesh is None else " over %d devices" % mesh.devices.size,
           result.evidence, result.uncertainty, result.perplexity,
           len(result.proposal), dt, card))
    if not abs(result.evidence - 1.0) < 0.01:
        raise AssertionError("evidence %.5f not within 1%%" % result.evidence)


def phase_sharded_update(card, devices):
    """One pmc_update sharded over the mesh against the same update on the
    samples gathered to one card."""
    from functools import partial

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pypmc_tpu.density import core
    from pypmc_tpu.mix_adapt.pmc import pmc_update
    from pypmc_tpu.parallel import particle_mesh

    params, t_params, _ = pmc_large_scale_problem()
    n = N_IS
    xT, _, log_q, log_p = core.propose_logq_T(params, jax.random.PRNGKey(8), n,
                                              t_params)
    w = jax.numpy.exp(log_p - log_q)
    serial = pmc_update(params, xT, w, transposed=True)
    mesh = particle_mesh(devices)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(None, "particles"), P("particles")),
             out_specs=P(), check_vma=False)
    def sharded(p, s, wts):
        return pmc_update(p, s, wts, axis_name="particles", transposed=True).params

    xs = jax.device_put(xT, NamedSharding(mesh, P(None, "particles")))
    ws = jax.device_put(w, NamedSharding(mesh, P("particles")))
    out = jax.jit(sharded)(params, xs, ws)
    # float32 sums of 2^24 terms reduced in another order under NCCL:
    # relative error ~ sqrt(N) * eps ~ 5e-4 on the accumulated moments
    errs = {}
    for name, tol in (("weights", 1e-3), ("means", 2e-3), ("cov", 5e-3),
                      ("dof", 2e-2)):
        a = np.asarray(getattr(out, name), np.float64)
        b = np.asarray(getattr(serial.params, name), np.float64)
        errs[name] = float(np.max(np.abs(a - b) / (tol * (1 + np.abs(b)))))
    log("  sharded pmc_update over %d devices vs one card: err/tol %s (%s)"
        % (mesh.devices.size, errs, card))
    if max(errs.values()) > 1:
        raise AssertionError("sharded update differs: %s" % errs)


def run_phases(phases):
    failed = []
    for name, fn in phases:
        log("phase %s" % name)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log("phase %s FAILED" % name)
        else:
            log("phase %s ok (%.1f s)" % (name, time.perf_counter() - t0))
    return failed


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the particle-sharded path on 4 GPUs")
    args = ap.parse_args()

    import jax
    import pypmc_tpu  # noqa: F401  (fails at once outside a checkout)

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print("chip_smoke: no GPU found (platform %r)" % platform, file=sys.stderr)
        return 1
    use_compile_cache()
    card = card_line()
    log("card: %s" % card)
    log("jax %s, %d device(s): %s" % (jax.__version__, len(devices),
                                      devices[0].device_kind))

    if args.four_cards:
        if len(devices) < 4:
            print("chip_smoke: --four-cards needs 4 GPUs, found %d" % len(devices),
                  file=sys.stderr)
            return 1
        four = devices[:4]
        phases = [
            ("4a pmc_run_sharded 4x10^7", lambda: phase_pmc_sharded(
                card, four, 4 * N_PMC)),
            ("4b sharded pmc_update", lambda: phase_sharded_update(card, four)),
            ("4c integrate(mesh=)", lambda: phase_integrate(
                card, __import__("pypmc_tpu").parallel.particle_mesh(four))),
        ]
    else:
        phases = [
            ("1 kernel", lambda: phase_kernel(card)),
            ("2 IS step", lambda: phase_is_step(card)),
            ("3 pmc_run_sharded", lambda: phase_pmc_sharded(card, devices[:1])),
            ("4 chain pool + VB", lambda: phase_chains_vb(card)),
            ("5 integrate", lambda: phase_integrate(card)),
        ]
    failed = run_phases(phases)
    if failed:
        print("chip_smoke: failed phases: %s" % failed, file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
