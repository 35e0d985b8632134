"""Early pytest plugin: the full-suite multi-process mode.

Loaded via ``addopts = -p _testenv_reexec`` in pytest.ini, which runs this
module BEFORE pytest enables fd-level output capture -- spawning the
processes from conftest.py would inherit the capture file descriptors and
lose all output.
"""

import os
import sys

# ------------------------------------------------------------------ #
# Full-suite multi-process re-run (PYPMC_TEST_NPROC=2)
#
# The reference re-runs its ENTIRE unittest suite under ``mpirun -n 2``
# (``/root/reference/Makefile:101-104``): every rank executes every test,
# and the distributed layer underneath is live the whole time.  The analog
# here: spawn two pytest processes joined into ONE ``jax.distributed``
# runtime (4 virtual CPU devices each -> the same 8-device global mesh the
# single-process suite uses, now spanning a real process boundary).
# Tests that must materialize non-addressable (cross-process-sharded)
# arrays on the host are skip-marked by tests/conftest.py.
#
# Both processes must execute the same sequence of multi-process
# computations, so pytest options that reorder or early-exit (-x, -k with
# per-process effects) should not be combined with this mode.
# ------------------------------------------------------------------ #

_NPROC_CHILD = "PYPMC_TEST_PROC_ID"

if (os.environ.get("PYPMC_TEST_NPROC") == "2"
        and _NPROC_CHILD not in os.environ):
    import socket
    import subprocess
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = "localhost:%d" % port

    env = dict(os.environ)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(
        flags + ["--xla_force_host_platform_device_count=4"])
    env["PYPMC_TEST_COORD"] = coord

    procs = []
    logs = []
    for pid in range(2):
        child_env = dict(env)
        child_env[_NPROC_CHILD] = str(pid)
        if pid == 0:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pytest"] + sys.argv[1:],
                env=child_env))
            logs.append(None)
        else:
            log = tempfile.NamedTemporaryFile(
                mode="w+", suffix=".proc%d.log" % pid, delete=False)
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pytest"] + sys.argv[1:],
                env=child_env, stdout=log, stderr=subprocess.STDOUT))
    # a child dying mid-collective leaves its sibling blocked inside a
    # jax.distributed psum forever -- poll with a grace period instead of
    # a blind wait, and kill the survivor so the run always terminates
    # with diagnostics
    import time as _time

    deadline = _time.time() + float(
        os.environ.get("PYPMC_TEST_NPROC_TIMEOUT", 3600))
    first_exit = None
    rcs = [None, None]
    while any(rc is None for rc in rcs):
        for pid, proc in enumerate(procs):
            if rcs[pid] is None:
                rcs[pid] = proc.poll()
        now = _time.time()
        done = [rc is not None for rc in rcs]
        if all(done):
            break
        if first_exit is None and any(done):
            first_exit = now
        # one child exited (cleanly or not) >120 s ago, or global timeout:
        # the survivor is almost certainly deadlocked in a collective
        if (first_exit is not None and now - first_exit > 120) or now > deadline:
            for pid, proc in enumerate(procs):
                if rcs[pid] is None:
                    sys.stderr.write(
                        "---- killing process %d (sibling exited %s; likely "
                        "blocked in a collective) ----\n"
                        % (pid, "rc=%s" % rcs[1 - pid]))
                    proc.kill()
                    rcs[pid] = proc.wait()
            break
        _time.sleep(1)
    if any(rcs):
        for pid, log in enumerate(logs):
            if log is not None and rcs[pid]:
                log.seek(0)
                sys.stderr.write("---- process %d output (rc=%d) ----\n%s\n"
                                 % (pid, rcs[pid], log.read()[-8000:]))
    sys.exit(max(rcs))
