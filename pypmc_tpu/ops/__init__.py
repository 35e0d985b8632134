"""Low-level kernels: batched linear algebra, log-sum-exp, chi-square
samplers and the fused GPU mixture log-density."""

from .linalg import CholResult, bilinear_sym, chol_inv_det, symmetrize
from .lse import logsumexp, logsumexp2D, regularize, tiny
from .random import chi2_log, chisquare, student_t_scale
