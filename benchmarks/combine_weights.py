"""Deterministic-mixture (AMIS) weight combination at the north-star scale:
T = 10 proposals x N = 10^6 samples each (10^7 total), K = 10, D = 10.

The reference loops T*T host numpy evaluations
(``/root/reference/pypmc/sampler/importance_sampling.py:238-371``); here each
run's samples are uploaded once (transposed) and all T proposals evaluate
on device, so the whole combination costs ~T^2 mixture evaluation passes
with no host round-trips in between.

Usage: python benchmarks/combine_weights.py [--runs 10] [--n 1000000]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pypmc_tpu as pt  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    proposals = []
    samples = []
    weights = []
    for t in range(args.runs):
        means = rng.normal(0, 3, size=(args.k, args.dim))
        a = rng.normal(0, 0.2, size=(args.k, args.dim, args.dim))
        covs = np.eye(args.dim)[None] * 1.5 + np.einsum("kij,klj->kil", a, a)
        mix = pt.density.create_gaussian_mixture(means, covs)
        proposals.append(mix)
        samples.append(np.asarray(mix.propose(args.n, rng=t)))
        weights.append(np.abs(rng.normal(1.0, 0.3, size=args.n)))

    # warm the compile caches at FULL size: the device step is jitted per
    # shape, so a small-slice warmup would leave the timed run paying the
    # N=10^6 compile.  Warm on PERTURBED weights, so the timed call is not
    # an exact replay of the warmup.
    _ = pt.sampler.combine_weights(
        [s + 0.125 for s in samples], [w + 0.125 for w in weights], proposals)

    t0 = time.perf_counter()
    combined = pt.sampler.combine_weights(samples, weights, proposals)
    dt = time.perf_counter() - t0
    total = args.runs * args.n
    print("combine_weights: T=%d runs x N=%d = %.1e samples in %.2f s "
          "(%.1f M samples/s; %d proposal-evaluation passes)"
          % (args.runs, args.n, total, dt, total / dt / 1e6,
             args.runs * args.runs))
    assert np.isfinite(combined[:][:, 0]).all()


if __name__ == "__main__":
    main()
