"""Two-process ``jax.distributed`` tests -- the analog of the reference's
``mpirun -n 2`` re-run pattern (``Makefile:101-104``) and its rank-aware
assertions (``tools/parallel_sampler_test.py:41-124``).

One two-process launch (session-scoped; process spawns are expensive) runs
several scenario checks inside the workers; each scenario is surfaced as its
own test by parsing the per-check marker lines:

* PMC update bit-identity: sharded psum'ed statistics == single-process.
* Multi-process IS+PMC run: every process computes the IDENTICAL adapted
  mixture (digest equality across processes) -- the property that replaces
  the reference's proposal broadcast.
* Multi-process sharded VB: the E-step under the 2-process mesh matches a
  full-data single-process run.
* Non-divisible n_total: accepted (rounded up) across processes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import numpy as np

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax

jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=2,
    process_id=int(sys.argv[2]),
)
jax.config.update("jax_enable_x64", True)

import hashlib
import jax.numpy as jnp
from functools import partial
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from pypmc_tpu.density import core
from pypmc_tpu.mix_adapt.pmc import pmc_update
from pypmc_tpu.parallel import particle_mesh, pmc_run_sharded

assert len(jax.devices()) == 4  # 2 processes x 2 local devices
PID = int(sys.argv[2])


def report(name, ok, extra=""):
    print("CHECK %s %s %s" % (name, "OK" if ok else "MISMATCH", extra),
          flush=True)
    return ok


def digest(tree):
    h = hashlib.sha256()
    for leaf in jax.tree.leaves(tree):
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()[:16]


all_ok = True

# ---- 1. PMC update bit-identity (psum'ed stats == single process) ---- #
MEANS = np.array([[1.0, -1.0], [2.0, 3.0]])
COVS = np.array([[[1.3, 0.7], [0.7, 1.5]], [[0.5, 0.0], [0.0, 0.5]]])
params, _ = core.make_mixture(MEANS, COVS, np.array([0.5, 0.5]))

n = 4 * 100
rng = np.random.default_rng(0)
samples = rng.normal(size=(n, 2))
weights = np.abs(rng.normal(1.0, 0.2, size=n))

serial = pmc_update(params, jnp.asarray(samples), jnp.asarray(weights))

mesh = particle_mesh()

@partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("particles"), P("particles")),
         out_specs=P())
def sharded(params, s, w):
    return pmc_update(params, s, w, axis_name="particles").params

# make_array_from_process_local_data takes each process's LOCAL rows; this
# process owns the contiguous middle half of the global particle set
sharding = NamedSharding(mesh, P("particles"))
lo, hi = PID * (n // 2), (PID + 1) * (n // 2)
s_global = jax.make_array_from_process_local_data(sharding, samples[lo:hi])
w_global = jax.make_array_from_process_local_data(sharding, weights[lo:hi])
assert s_global.shape == (n, 2), s_global.shape
out = jax.jit(sharded)(params, s_global, w_global)
all_ok &= report("pmc_identity",
    np.allclose(np.asarray(serial.params.weights), np.asarray(out.weights), atol=1e-12)
    and np.allclose(np.asarray(serial.params.means), np.asarray(out.means), atol=1e-12)
    and np.allclose(np.asarray(serial.params.cov), np.asarray(out.cov), atol=1e-12))

# ---- 2. multi-process IS+PMC run: identical mixture on every process ---- #
t_params, _ = core.make_mixture(
    np.array([[-2.0, 0.0], [2.0, 0.5]]),
    np.array([np.eye(2) * 0.8] * 2),
    np.array([0.3, 0.7]))
p0, _ = core.make_mixture(
    np.array([[-1.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    np.array([np.eye(2) * 3.0] * 3))
adapted, stats = pmc_run_sharded(t_params, p0, n_total=4 * 256, n_steps=3,
                                 mesh=mesh, key=jax.random.PRNGKey(7))
finite = (np.isfinite(np.asarray(stats.ess)).all()
          and np.isfinite(np.asarray(adapted.means)).all())
# the digest line is compared ACROSS processes by the pytest parent --
# identical output proves no process needed a proposal broadcast
print("DIGEST is_pmc %s" % digest(adapted), flush=True)
all_ok &= report("is_pmc_run", finite, "ess=%s" % np.asarray(stats.ess))

# ---- 3. multi-process sharded VB vs single-process full-data run ---- #
from pypmc_tpu.mix_adapt.variational import GaussianInference

n_vb = 4 * 300
data = np.vstack([np.random.default_rng(1).normal(-2, 0.5, size=(n_vb // 2, 2)),
                  np.random.default_rng(2).normal(2, 0.5, size=(n_vb // 2, 2))])
m_init = np.array([[-1.0, -1.0], [1.0, 1.0]])
plain = GaussianInference(data, components=2, nu=np.full(2, 3.0), m=m_init)
plain.run(20, prune=0.0)

d_global = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("particles", None)),
    data[PID * (n_vb // 2):(PID + 1) * (n_vb // 2)])
assert d_global.shape == (n_vb, 2), d_global.shape
vb = GaussianInference(d_global, components=2, nu=np.full(2, 3.0), mesh=mesh,
                       m=m_init)
vb.run(20, prune=0.0)
all_ok &= report("vb_sharded",
    np.allclose(np.asarray(vb.N_comp), np.asarray(plain.N_comp), rtol=1e-2, atol=1e-1)
    and np.isclose(vb.likelihood_bound(), plain.likelihood_bound(), rtol=1e-3))
print("DIGEST vb %s" % digest((vb.m, vb.W, vb.alpha)), flush=True)

# ---- 4. non-divisible n_total across processes (rounded up) ---- #
adapted2, stats2 = pmc_run_sharded(t_params, p0, n_total=403, n_steps=1,
                                   mesh=mesh, key=jax.random.PRNGKey(9))
all_ok &= report("non_divisible",
                 np.isfinite(np.asarray(adapted2.means)).all())

# ---- 5. checkpoint writes into a SHARED directory: process-0-gated ---- #
# Both processes call the savers on the SAME path (exactly what
# pipeline.integrate(checkpoint_dir=) does in a multi-process run); only
# process 0 may write, and the write-then-resume roundtrip must hand every
# process identical state.
from jax.experimental import multihost_utils
from pypmc_tpu import checkpoint as ckpt

shared_dir = sys.argv[3]
gate_path = os.path.join(shared_dir, "gate.npz")
ckpt.atomic_savez(gate_path, marker=np.array([float(PID)]))
mix_path = os.path.join(shared_dir, "adapted.npz")
ckpt.save_mixture(mix_path, adapted)
multihost_utils.sync_global_devices("ckpt_written")
with np.load(gate_path) as f:
    surviving_writer = int(f["marker"][0])
loaded = ckpt.load_mixture_params(mix_path)  # resume on BOTH processes
all_ok &= report(
    "ckpt_gate",
    surviving_writer == 0
    and ckpt.is_primary_process() == (PID == 0)
    and np.allclose(np.asarray(loaded.means), np.asarray(adapted.means)),
    "writer=%d" % surviving_writer)
print("DIGEST ckpt %s" % digest(
    (loaded.means, loaded.cov, loaded.weights)), flush=True)

print("RESULT", PID, "OK" if all_ok else "MISMATCH", flush=True)
sys.exit(0 if all_ok else 1)
"""


def _launch():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = "127.0.0.1:%d" % port

    import tempfile
    workdir = tempfile.mkdtemp(prefix="pypmc_dist_")
    worker_file = os.path.join(workdir, "worker.py")
    with open(worker_file, "w") as f:
        f.write(_WORKER)
    shared_ckpt_dir = os.path.join(workdir, "ckpt")
    os.makedirs(shared_ckpt_dir, exist_ok=True)

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, worker_file, coord, str(i), shared_ckpt_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outputs.append(out)
    return procs, outputs


@pytest.fixture(scope="module")
def dist_run():
    procs, outputs = _launch()
    return procs, outputs


def _check_marker(outputs, name):
    for i, out in enumerate(outputs):
        line = [l for l in out.splitlines() if l.startswith("CHECK " + name)]
        assert line, "process %d never reported %s:\n%s" % (i, name, out[-2000:])
        assert " OK" in line[0], "process %d: %s" % (i, line[0])


@pytest.mark.slow
def test_two_process_workers_exit_cleanly(dist_run):
    procs, outputs = dist_run
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, "process %d failed:\n%s" % (i, out[-3000:])


@pytest.mark.slow
def test_two_process_distributed_pmc(dist_run):
    _check_marker(dist_run[1], "pmc_identity")


@pytest.mark.slow
def test_two_process_is_pmc_run(dist_run):
    _check_marker(dist_run[1], "is_pmc_run")


@pytest.mark.slow
def test_two_process_vb_sharded(dist_run):
    _check_marker(dist_run[1], "vb_sharded")


@pytest.mark.slow
def test_two_process_non_divisible_n(dist_run):
    _check_marker(dist_run[1], "non_divisible")


@pytest.mark.slow
def test_two_process_checkpoint_gating(dist_run):
    """Checkpoint writes into a SHARED directory are process-0-gated (the
    round-4 concurrent same-path write race) and the write->resume
    roundtrip hands both processes the saved state."""
    _check_marker(dist_run[1], "ckpt_gate")


@pytest.mark.slow
def test_processes_agree_without_broadcast(dist_run):
    """Every process must print the SAME digest for the adapted mixture and
    the VB posterior: the psum'ed-statistics design means no process ever
    needs the reference's rank-0 proposal broadcast
    (``examples/pmc_mpi.py:128``)."""
    _, outputs = dist_run
    for tag in ("is_pmc", "vb", "ckpt"):
        digests = []
        for i, out in enumerate(outputs):
            line = [l for l in out.splitlines()
                    if l.startswith("DIGEST " + tag)]
            assert line, "process %d printed no %s digest" % (i, tag)
            digests.append(line[0])
        assert digests[0] == digests[1], digests
