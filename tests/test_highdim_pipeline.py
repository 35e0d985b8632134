"""High-dimensional evidence accuracy: the reference's headline claim of
<=1% multimodal-integration error in up to 30-40 dimensions
(``/root/reference/doc/abstract.txt:6-10``), exercised through the full
MCMC -> R-grouping -> VB -> IS -> weighted-VB -> IS -> combine pipeline.

Three accuracy cases (VERDICT r4 item 5 -- previously only D=20 was
suite-guarded; the D=40 Gaussian and D=40 heavy-tailed Student-t runs,
where the round-4 float32 failure modes actually bit, were not
suite-guarded):

* D=20 Gaussian target, in-process (float64 CPU under the suite config);
* D=40 Gaussian target, SUBPROCESS in true float32 (the measured claim is
  a float32 claim -- the suite's x64 mode would sidestep the failure
  modes being guarded);
* D=40 Student-t target (dof 10/14, clipped adaptation), subprocess f32.

Plus one regression per round-4 failure-mode fix:

1. VB starvation floor (prune >= D+1) -- test_vb_prune_floor;
2. K_g=1 long-patch policy -- test_K_g_default;
3. float32 underflow routing in combine_weights --
   ``test_importance_sampling.py::test_combine_weights_zero_weights_stay_on_log_path``;
4. Ionides weight clipping for the PMC adaptation -- test_adaptation_clips.

Production-scale float32 numbers on the GPU: not measured yet (PERF.md)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmarks.accuracy_highdim import run_pipeline

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_evidence_within_one_percent_d20():
    result = run_pipeline(
        20, n_chains=16, mcmc_steps=300, mcmc_cycles=12, thin=5,
        n_is1=1 << 17, n_is2=1 << 19, seed=2024, verbose=False)
    assert result["abs_error_pct"] < 1.0, result
    assert result["ess"] > 0.1, result


def _run_f32_subprocess(extra_args, timeout=1500):
    """Run the accuracy harness in a fresh interpreter WITHOUT x64 (true
    float32, the measured configuration); inherits the suite's scrubbed
    CPU env."""
    cmd = [sys.executable, os.path.join(_REPO, "benchmarks",
                                        "accuracy_highdim.py"),
           "--json"] + extra_args
    proc = subprocess.run(cmd, cwd=_REPO, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("JSON ")]
    assert line, proc.stdout[-3000:]
    return json.loads(line[0][5:])


# reduced-budget configurations (~1 min each on CPU): 16 chains x 16k
# steps, 0.66M IS samples
_D40_BUDGET = ["--dim", "40", "--chains", "16", "--mcmc-steps", "1600",
               "--mcmc-cycles", "10", "--is-samples", str(1 << 19)]


@pytest.mark.slow
def test_evidence_within_one_percent_d40_f32():
    """D=40 Gaussian target in float32 (measured 0.20% error, ESS 0.37).
    Guards the starvation floor + K_g policy + underflow routing stack:
    reverting any of them pushed this configuration far past 1% in the
    round-4 measurements."""
    r = _run_f32_subprocess(_D40_BUDGET)
    assert r["abs_error_pct"] < 1.0, r
    assert r["ess"] > 0.15, r


@pytest.mark.slow
def test_evidence_within_one_percent_d40_student_t_f32():
    """D=40 heavy-tailed Student-t target (dof 10/14) in float32 with the
    clipped adaptation (measured 0.23% error, ESS 0.35).  Without the
    Ionides clipping this configuration degenerated to Z=0.86 +- 0.06 at
    ESS 3e-4 (every PMC component died)."""
    r = _run_f32_subprocess(_D40_BUDGET + ["--student-t-target"])
    assert r["abs_error_pct"] < 1.0, r
    assert r["ess"] > 0.15, r


# ------------------------------------------------------------------ #
# Per-fix regressions (cheap, exact mechanism checks)
# ------------------------------------------------------------------ #

def _tiny_target(dim):
    import pypmc_tpu as pt

    means = np.stack([np.zeros(dim), np.full(dim, 3.0)])
    covs = np.array([np.eye(dim) * 0.7] * 2)
    return pt.density.create_gaussian_mixture(means, covs,
                                              np.array([0.4, 0.6]))


def _tiny_starts(dim, n=8):
    rng = np.random.default_rng(0)
    return np.vstack([rng.normal(0, 1.5, (n // 2, dim)),
                      rng.normal(3, 1.5, (n // 2, dim))])


def test_vb_prune_floor(monkeypatch):
    """The pipeline must never let a VB component keep fewer than D+1
    members: a smaller component has a singular scatter and its precision
    overflows float32 (round-4 failure mode 1).  Captures the prune
    threshold integrate actually passes to the first VB fit."""
    import pypmc_tpu as pt
    from pypmc_tpu.mix_adapt.variational import GaussianInference

    seen = []
    orig = GaussianInference.run

    def spy(self, *args, **kwargs):
        seen.append(kwargs.get("prune", args[1] if len(args) > 1 else None))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(GaussianInference, "run", spy)
    dim = 6
    pt.pipeline.integrate(_tiny_target(dim), dim, _tiny_starts(dim),
                          mcmc_steps=100, mcmc_cycles=4, n_is1=1 << 12,
                          n_is2=1 << 12, pmc_steps=1)
    assert seen, "integrate never ran VB"
    assert seen[0] >= dim + 1.0, seen


def test_K_g_default():
    """K_g (long patches per chain group) must default to 1: K_g > 1 tiles
    each mode with narrow sub-components whose joint tail coverage decays
    exponentially with D (round-4 failure mode 2; measured K_g=4 at D=20
    -> Z=0.35)."""
    import inspect

    import pypmc_tpu as pt

    sig = inspect.signature(pt.pipeline.integrate)
    assert sig.parameters["K_g"].default == 1


def test_adaptation_clips(monkeypatch):
    """With the default ``pmc_weight_clip=True`` the PMC refinement must
    adapt on weights truncated at mean(w) * sqrt(n) (Ionides 2008,
    round-4 failure mode 4).  The target log-density handed to the
    refinement is rigged so ONE sample per run carries an e^40 weight
    spike -- exactly the heavy-tail pathology the clip exists for -- and
    the update call the pipeline actually makes is captured: it must see
    the spike truncated to the Ionides bound, not raw."""
    import pypmc_tpu as pt
    from pypmc_tpu.density import core as core_mod
    from pypmc_tpu.mix_adapt import pmc as pmc_mod

    unclipped, captured = [], []
    orig_propose = core_mod.propose_logq_T
    orig_update = pmc_mod.pmc_update

    def rigged_propose(params, key, n, target_params=None, **kwargs):
        out = orig_propose(params, key, n, target_params, **kwargs)
        if target_params is None:  # plain IS propose: 3-tuple, pass through
            return out
        samples_T, lat, log_q, log_p = out
        log_p = log_p.at[0].add(40.0)  # one dominating tail weight
        unclipped.append(np.exp(np.asarray(log_p) - np.asarray(log_q)))
        return samples_T, lat, log_q, log_p

    def spy_update(params, samples, weights, **kwargs):
        captured.append(np.asarray(weights))
        return orig_update(params, samples, weights, **kwargs)

    monkeypatch.setattr(core_mod, "propose_logq_T", rigged_propose)
    monkeypatch.setattr(pmc_mod, "pmc_update", spy_update)
    dim = 3
    pt.pipeline.integrate(_tiny_target(dim), dim, _tiny_starts(dim),
                          mcmc_steps=100, mcmc_cycles=4, n_is1=1 << 12,
                          n_is2=1 << 12, pmc_steps=2)
    assert captured, "integrate never ran a PMC update"
    # the update saw each run's spike truncated to mean(w) * sqrt(n)
    for i, w_adapt in enumerate(captured):
        # captured[i] corresponds to the i-th propose of the clip loop
        w_raw = unclipped[i]
        bound = w_raw.mean() * np.sqrt(float(len(w_raw)))
        assert w_adapt.max() < 0.99 * w_raw.max(), \
            "spike reached the adaptation unclipped"
        np.testing.assert_allclose(w_adapt.max(), bound, rtol=1e-3)
