"""pypmc_tpu -- an accelerator-native adaptive importance-sampling framework.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of pypmc:
Gaussian/Student-t mixture proposals, (M-)PMC mixture updates, variational
Bayes GMM fitting, adaptive-Metropolis MCMC, hierarchical mixture reduction,
and particle-axis data parallelism over device meshes (replacing pypmc's
MPI layer with ``shard_map`` + ``psum`` collectives).
"""

from ._version import __version__

from . import checkpoint
from . import density
from . import mix_adapt
from . import parallel
from . import pipeline
from . import profiling
from . import sampler
from . import tools

from .tools.util import log_to_stdout

log_to_stdout()
