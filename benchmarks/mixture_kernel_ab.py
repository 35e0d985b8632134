"""Fused mixture log-density kernel against the plain XLA form, on the GPU.

Times, at N=2^24 and (K, D) = (10, 10), (2, 10), (400, 2), (64, 40):

* ``log q``: ``core.mixture_logpdf_T`` through the kernel, against XLA's
  ``component_logpdfs`` + weighted ``logsumexp``;
* ``rho``: ``calculate_rho_rb_T`` through the kernel against XLA (N=2^22:
  the (K, N) output alone is 6.7 GB at K=400);
* the IS step end to end (``propose_logq_T`` + weights, bench.py's
  problem: Student-t proposal K=10, D=10, bimodal target), both ways.

The XLA side is reached by switching the dispatch (``use_kernel``) off
before tracing.  Kernel and XLA run in alternating rounds in one process;
each number is the median of the rounds' medians.  An XLA form that runs
out of device memory is reported as such, and both forms are then timed
again at N=2^20.  ``--blocks`` also times the kernel's log q at other
particle blocks per program.

    python benchmarks/mixture_kernel_ab.py [--out chiprun_out/mixture_kernel_ab.json]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SHAPES = [(10, 10, True), (2, 10, False), (400, 2, False), (64, 40, True)]
N_LOGQ = 1 << 24
N_RHO = 1 << 22
N_IS = 1 << 24
N_SMALL = 1 << 20
REPS = 10
ROUNDS = 2


def timed(fn, *args):
    """Median wall time of ``REPS`` calls, each waited on."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def build(kind, use_kernel):
    """A fresh jitted function traced with the dispatch set as asked."""
    import jax
    import jax.numpy as jnp
    from pypmc_tpu.density import core
    from pypmc_tpu.mix_adapt.pmc import calculate_rho_rb_T
    from pypmc_tpu.ops import mixture_kernel

    orig = mixture_kernel.use_kernel
    choose = orig if use_kernel else (lambda x: False)

    def traced(f):
        def g(*args):
            mixture_kernel.use_kernel = choose
            try:
                return f(*args)
            finally:
                mixture_kernel.use_kernel = orig
        return jax.jit(g)

    if kind == "logq":
        return traced(core.mixture_logpdf_T)
    if kind == "rho":
        return traced(calculate_rho_rb_T)

    def is_step(params, t_params, key):
        samples_T, latent, log_q, log_p = core.propose_logq_T.__wrapped__(
            params, key, N_IS, t_params)
        w = jnp.exp(log_p - log_q)
        return jnp.sum(w), jnp.sum(w * w)

    return traced(is_step)


def out_of_memory(e):
    """An allocation failure, also when it surfaces while XLA autotunes."""
    text = str(e)
    return ("RESOURCE_EXHAUSTED" in text or "out of memory" in text.lower()
            or "Autotuning failed" in text)


def measure(kind, args):
    out = {}
    for r in range(ROUNDS):
        for use_kernel in ((True, False) if r % 2 == 0 else (False, True)):
            name = "kernel" if use_kernel else "xla"
            if out.get(name) == "out of memory":
                continue
            try:
                t = timed(build(kind, use_kernel), *args)
            except Exception as e:  # XLA's (N, K, D) intermediates can exceed the card
                if not out_of_memory(e):
                    raise
                out[name] = "out of memory"
                continue
            out.setdefault(name + "_rounds", []).append(t)
    for name in ("kernel", "xla"):
        if name + "_rounds" in out:
            out[name + "_ms"] = 1e3 * float(np.median(out[name + "_rounds"]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--blocks", action="store_true",
                    help="also time log q at other particle blocks per program")
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("mixture_kernel_ab: no GPU found", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print("card:", card, flush=True)

    import chip_smoke
    from pypmc_tpu.density import core
    from pypmc_tpu.ops import mixture_kernel

    results = []
    for K, D, student_t in SHAPES:
        params = chip_smoke.random_mixture(K, D, student_t)
        xT = core.propose_T(params, jax.random.PRNGKey(K + D), N_LOGQ)[0]
        for kind, x in (("logq", xT), ("rho", xT[:, :N_RHO])):
            row = dict(op=kind, K=K, D=D, student_t=student_t, N=int(x.shape[1]),
                       card=card, **measure(kind, (params, x)))
            print(json.dumps(row), flush=True)
            results.append(row)
            if row.get("xla") == "out of memory":
                row = dict(op=kind, K=K, D=D, student_t=student_t, N=N_SMALL,
                           card=card, **measure(kind, (params, xT[:, :N_SMALL])))
                print(json.dumps(row), flush=True)
                results.append(row)
        if args.blocks:
            orig = mixture_kernel._block_size
            # at most 256 registers of particle rows per thread (4 warps)
            for block in [b for b in (128, 256, 512, 1024, 2048)
                          if D * b // 128 <= 256]:
                mixture_kernel._block_size = lambda dim, b=block: b
                try:
                    t = timed(build("logq", True), params, xT)
                finally:
                    mixture_kernel._block_size = orig
                row = dict(op="logq_block", K=K, D=D, N=N_LOGQ, block=block,
                           default_block=orig(D), card=card, kernel_ms=1e3 * t)
                print(json.dumps(row), flush=True)
                results.append(row)
        del xT

    params, t_params = chip_smoke.bench_problem()
    row = dict(op="is_step", K=10, D=10, student_t=True, N=N_IS, card=card,
               **measure("is", (params, t_params, jax.random.PRNGKey(0))))
    print(json.dumps(row), flush=True)
    results.append(row)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
