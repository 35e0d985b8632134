"""Run ``examples/pmc_large_scale.py`` under a 2-process ``jax.distributed``
runtime and assert both processes computed the IDENTICAL adapted mixture --
the acceptance analog of the reference's ``mpirun -n 2 examples/pmc_mpi.py``
(``/root/reference/Makefile:118-134``).

    python examples/launch_2proc.py --particles 100000 --steps 3

Each process gets one virtual CPU device (a 2-device global mesh spanning a
real process boundary); any extra arguments are forwarded to the example.
Exits 0 iff both processes succeed AND print the same ``adapted digest``
line (identical results from psum'ed statistics replace the reference's
rank-0 proposal broadcast).
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "pmc_large_scale.py")


def main():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    base_env = dict(os.environ)
    # a pure-CPU runtime regardless of attached accelerators: the scenario
    # under test is the process boundary, not the card
    base_env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
        "JAX_COORDINATOR_ADDRESS": "127.0.0.1:%d" % port,
        "JAX_NUM_PROCESSES": "2",
    })
    base_env["PYTHONPATH"] = REPO + os.pathsep + base_env.get("PYTHONPATH", "")

    procs = []
    for pid in range(2):
        env = dict(base_env, JAX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, EXAMPLE] + sys.argv[1:],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))

    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outputs.append(out)

    ok = True
    digests = []
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        if p.returncode != 0:
            print("process %d FAILED (rc=%s):\n%s"
                  % (pid, p.returncode, out[-3000:]))
            ok = False
            continue
        line = [l for l in out.splitlines() if l.startswith("adapted digest:")]
        if not line:
            print("process %d printed no digest:\n%s" % (pid, out[-2000:]))
            ok = False
        else:
            digests.append(line[0])
        if pid == 0:
            sys.stdout.write(out)
    if ok and len(set(digests)) != 1:
        print("DIGEST MISMATCH across processes: %s" % digests)
        ok = False
    print("2-process run: %s" % ("OK (identical adapted mixture on both "
                                 "processes)" if ok else "FAILED"))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
