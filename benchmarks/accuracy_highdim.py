"""High-dimensional evidence-accuracy acceptance run.

The reference's headline capability claim is <=1% integration error on
multimodal problems in up to 30-40 dimensions, typically without manual
tuning (``/root/reference/doc/abstract.txt:6-10``,
``/root/reference/README.md:15-18``).  This harness demonstrates that claim
for the float32 device path, end to end:

    adaptive-MCMC chain pool  ->  Gelman-Rubin grouping / long-patches
    mixture  ->  variational Bayes  ->  importance sampling  ->  weighted-VB
    proposal refinement  ->  second IS run  ->  deterministic-mixture
    combination  ->  evidence

against a D-dimensional bimodal Gaussian-mixture target whose evidence is
analytically 1.  Everything device-side (the MCMC pool, the VB E-step, the
IS propose/evaluate step, combine_weights) runs the same code the
production configuration uses.

Usage:
    python benchmarks/accuracy_highdim.py --dim 20
    python benchmarks/accuracy_highdim.py --dim 40 --is-samples 4194304
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pypmc_tpu as pt  # noqa: E402


def make_target(dim, seed=7, separation=6.0, student_t=False):
    """A bimodal D-dimensional mixture (weights 0.35/0.65) with
    anisotropic, rotated covariances and modes ``separation`` apart along a
    random direction.  Normalized, so the analytic evidence is exactly 1.
    With ``student_t``, the components are Student-t with dof 10/14 (the
    reference's heavy-tailed regime)."""
    rng = np.random.default_rng(seed)
    direction = rng.normal(size=dim)
    direction /= np.linalg.norm(direction)
    means = np.stack([np.zeros(dim), separation * direction])
    covs = []
    for _ in range(2):
        a = rng.normal(0, 0.15 / np.sqrt(dim), size=(dim, dim))
        covs.append(np.eye(dim) * rng.uniform(0.5, 1.0) + a @ a.T)
    weights = np.array([0.35, 0.65])
    if student_t:
        return pt.density.create_t_mixture(
            means, np.array(covs), np.array([10.0, 14.0]), weights)
    return pt.density.create_gaussian_mixture(means, np.array(covs), weights)


def run_pipeline(dim, n_chains=32, mcmc_steps=400, mcmc_cycles=12, thin=5,
                 n_is1=1 << 19, n_is2=1 << 21, K_g=1, seed=2024,
                 inflate=2.0, pmc_steps=10, pmc_dof=8.0, student_t_target=False,
                 verbose=True):
    """Build the analytic-evidence target, draw overdispersed starts, and
    run the library pipeline (:func:`pypmc_tpu.pipeline.integrate` -- the
    stages and high-D defaults live THERE; this harness only grades the
    result against the known evidence of 1)."""
    import jax

    target_mixture = make_target(dim, student_t=student_t_target)
    rng = np.random.default_rng(seed)
    which = rng.integers(0, 2, n_chains)
    if student_t_target:
        m, c, _, _ = pt.density.recover_t_mixture(target_mixture)
    else:
        m, c, _ = pt.density.recover_gaussian_mixture(target_mixture)
    # overdispersed initialization: mode centers + 4x-inflated mode noise
    starts = np.stack([rng.multivariate_normal(m[k], 4.0 * c[k]) for k in which])

    t0 = time.perf_counter()
    r = pt.pipeline.integrate(
        target_mixture, dim, starts, key=jax.random.PRNGKey(seed),
        mcmc_steps=mcmc_steps, mcmc_cycles=mcmc_cycles, thin=thin, K_g=K_g,
        inflate=inflate, pmc_steps=pmc_steps, pmc_dof=pmc_dof,
        n_is1=n_is1, n_is2=n_is2, verbose=verbose)
    wall = time.perf_counter() - t0

    result = {
        "dim": dim,
        "evidence": r.evidence,
        "evidence_uncertainty": r.uncertainty,
        "abs_error_pct": abs(r.evidence - 1.0) * 100.0,
        "perplexity": r.perplexity,
        "ess": r.ess,
        "n_total": r.n_samples,
        "K_final": len(r.proposal),
        "t_total_s": wall,
        **{"t_%s" % k: v for k, v in r.details.items()
           if isinstance(v, float)},
    }
    if verbose:
        print("evidence = %.5f +- %.5f  (analytic 1; error %.3f%%)"
              % (r.evidence, r.uncertainty, result["abs_error_pct"]))
        print("perplexity %.3f  ESS %.3f  total %.1f s"
              % (r.perplexity, r.ess, wall))
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--mcmc-steps", type=int, default=400)
    ap.add_argument("--mcmc-cycles", type=int, default=12)
    ap.add_argument("--is-samples", type=int, default=1 << 21)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--student-t-target", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print the result dict as one JSON line (the slow "
                         "suite tests parse it)")
    args = ap.parse_args()

    result = run_pipeline(
        args.dim, n_chains=args.chains, mcmc_steps=args.mcmc_steps,
        mcmc_cycles=args.mcmc_cycles, n_is1=args.is_samples // 4,
        n_is2=args.is_samples, seed=args.seed,
        student_t_target=args.student_t_target)
    ok = result["abs_error_pct"] < 1.0
    if args.json:
        import json

        print("JSON " + json.dumps({k: (float(v) if hasattr(v, "item")
                                        or isinstance(v, float) else v)
                                    for k, v in result.items()}))
    print("RESULT %s: %.3f%% evidence error at D=%d (claim: <1%%)"
          % ("OK" if ok else "FAIL", result["abs_error_pct"], args.dim))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
