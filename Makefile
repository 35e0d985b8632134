# Developer targets (the reference's Makefile equivalents: build / check /
# check-parallel / run-examples / bench)

PYTHON ?= python
CPU_ENV = JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          MPLBACKEND=Agg PYTHONPATH=.

.PHONY: check check-fast check-parallel run-examples run-example-2proc \
        docs bench entry clean

# full unit + sharding test suite (8 virtual CPU devices, float64)
check:
	$(PYTHON) -m pytest tests/ -q

check-fast:
	$(PYTHON) -m pytest tests/ -q -x -m "not slow"

# the reference's `mpirun -n 2` full-suite re-run (Makefile:101-104):
# the ENTIRE suite under two pytest processes joined into one
# jax.distributed runtime (4 virtual CPU devices each = the same 8-device
# global mesh, spanning a real process boundary)
check-parallel:
	env PYPMC_TEST_NPROC=2 $(PYTHON) -m pytest tests/ -q

# run every example on the simulated 8-device CPU mesh
run-examples:
	for ex in pmc variational markov_chain mixture_reduction r_group pmc_sharded \
	          uniting_markov_chains_and_variational_bayes integrate_evidence; do \
	    echo "=== $$ex ==="; \
	    env $(CPU_ENV) $(PYTHON) examples/$$ex.py || exit 1; \
	done

# the reference's `mpirun -n 2 examples/pmc_mpi.py` acceptance analog:
# the large-scale PMC example under a 2-process jax.distributed runtime,
# asserting both processes compute the identical adapted mixture
run-example-2proc:
	$(PYTHON) examples/launch_2proc.py --particles 100000 --steps 3

# rendered documentation site + link/citation integrity check
docs:
	$(PYTHON) docs/gen_api.py --check
	$(PYTHON) docs/build_site.py

# throughput benchmark on the available accelerator (one JSON line)
bench:
	$(PYTHON) bench.py

# driver entry points: single-chip compile check + multichip dryrun (CPU mesh)
entry:
	env $(CPU_ENV) $(PYTHON) __graft_entry__.py

clean:
	rm -rf __pycache__ */__pycache__ */*/__pycache__ .pytest_cache *.png
