"""Abstract base probability-density classes.

API-parity layer with the reference (``pypmc/density/base.py:7-108``): the
same class names and method contracts, so code written against pypmc ports
directly.  All densities work on the log scale; ``evaluate`` returns
``log q(x)``.

The device compute path lives in :mod:`pypmc_tpu.density.core`; these
classes are thin host-side wrappers holding numpy parameters.
"""

import numpy as _np

__all__ = ["ProbabilityDensity", "LocalDensity"]


class ProbabilityDensity(object):
    """Abstract base class of a probability density; usable as a proposal
    for the importance sampler.  (Reference: ``density/base.py:7-66``.)
    """

    dim = 0

    def __init__(self):
        raise NotImplementedError(
            "abstract density class; instantiate a concrete subclass"
        )

    def evaluate(self, x):
        """Evaluate log of the density to propose ``x``, namely ``log(q(x))``."""
        raise NotImplementedError()

    def multi_evaluate(self, x, out=None):
        """Evaluate ``log(q(x))`` for each row in ``x``; write into ``out``
        if provided."""
        if out is None:
            out = _np.empty(len(x))
        else:
            assert len(out) == len(x)
        for i, point in enumerate(x):
            out[i] = self.evaluate(point)
        return out

    def propose(self, N=1, rng=None):
        """Propose ``N`` points using the random number generator or JAX key
        ``rng``."""
        raise NotImplementedError()


class LocalDensity(object):
    """Abstract base class for a conditional (local) probability density;
    usable as a proposal for the Markov-chain sampler.
    (Reference: ``density/base.py:68-108``.)
    """

    dim = 0
    symmetric = False

    def __init__(self):
        raise NotImplementedError(
            "abstract density class; instantiate a concrete subclass"
        )

    def evaluate(self, x, y):
        """Evaluate log of the density to propose ``x`` given ``y``:
        ``log(q(x|y))``."""
        raise NotImplementedError()

    def propose(self, y, rng=None):
        """Propose a new point given ``y``."""
        raise NotImplementedError()
