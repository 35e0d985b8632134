"""Gelman-Rubin R value [GR92] and chain grouping.

API parity with the reference's ``pypmc/mix_adapt/r_value.py``: group Markov
chains by their common R value and build a Gaussian or Student-t mixture from
"long patches" of the grouped chains [BC13].
"""

import numpy as _np

from ..density import partition as _part
from ..density.mixture import create_gaussian_mixture as _mkgauss
from ..density.mixture import create_t_mixture as _mkt

__all__ = ["r_value", "r_group", "make_r_gaussmix", "make_r_tmix"]


def r_value(means, variances, n, approx=False):
    """Gelman-Rubin potential-scale-reduction factor ([GR92] ch. 2.2) of
    ``m`` chains in ONE dimension, from the per-chain sample ``means`` and
    sample ``variances`` with ``n`` samples per chain.  ``approx=True``
    drops the degrees-of-freedom correction factor ``df/(df-2)``.
    (Same contract as the reference ``r_value.py:25-89``; re-derived from
    the published equations.)"""
    mu = _np.asarray(means, dtype=float)
    s2 = _np.asarray(variances, dtype=float)
    if mu.ndim != 1 or s2.ndim != 1:
        raise ValueError("per-chain means/variances must be 1-dimensional")
    if mu.shape != s2.shape:
        raise ValueError(
            "got %i chain means but %i chain variances" % (len(mu), len(s2)))
    m = len(mu)

    within = s2.mean()                      # W: mean within-chain variance
    between_n = mu.var(ddof=1)              # B/n: variance of chain means
    # pooled posterior-variance estimate sigma^2_+ ([GR92] below eq. 3)
    pooled = (n - 1.0) / n * within + between_n
    if approx:
        return pooled / within

    # scale of the t approximation and its variance, [GR92] eq. (4); the
    # second moments of (s^2, mu, mu^2) across chains in one covariance call
    scale = pooled + between_n / m
    moments = _np.cov(_np.stack([s2, mu, mu * mu]))
    var_scale = (
        ((n - 1.0) / n) ** 2 / m * moments[0, 0]
        + 2.0 * ((m + 1.0) / m) ** 2 / (m - 1.0) * between_n ** 2
        + 2.0 * (m + 1.0) * (n - 1.0) / (m * m * n)
        * (moments[0, 2] - 2.0 * mu.mean() * moments[0, 1])
    )
    df = 2.0 * scale * scale / var_scale
    if df <= 2.0:
        return _np.inf
    return scale / within * df / (df - 2.0)


def r_group(means, variances, n, critical_r=2.0, approx=False):
    """Group chains whose common :func:`r_value` is less than ``critical_r``
    in every dimension; greedy assignment in input order.
    (Reference: ``r_value.py:99-139``.)

    .. note::
        The per-dimension R criterion loses discriminating power at high
        D: two modes separated by distance ``s`` along a random direction
        project to only ``~s/sqrt(D)`` per coordinate, so at D >= ~20
        cross-mode chain pairs can pass ``critical_r`` while within-mode
        pairs fail it on sampling noise.  For high-dimensional use,
        grouping granularity matters less than component COUNT -- feed
        ``make_r_gaussmix(K_g=1)`` and let VB/PMC decide K."""
    means = _np.asarray(means)
    variances = _np.asarray(variances)
    if means.ndim != 2 or variances.ndim != 2:
        raise ValueError("chain means/variances must be (chains, dim) arrays")
    if means.shape != variances.shape:
        raise ValueError(
            "chain means %s and variances %s have mismatching shapes"
            % (means.shape, variances.shape))
    dim = means.shape[1]

    groups = []
    for i in range(len(means)):
        for group in groups:
            candidate = group + [i]
            ok = all(
                r_value(means[candidate, j], variances[candidate, j], n,
                        approx) < critical_r
                for j in range(dim)
            )
            if ok:
                group.append(i)
                break
        else:
            groups.append([i])

    return groups


def _make_r_patches(data, K_g, critical_r, indices, approx):
    """Group chains by R value and split each group into ``K_g`` patches;
    return patch means and covariances.  (Reference: ``r_value.py:141-199``.)"""

    def append_components(means, covs, data, partition):
        subdata_start = 0
        for len_subdata in partition:
            subdata = data[subdata_start : subdata_start + len_subdata]
            means.append(_np.mean(subdata, axis=0))
            covs.append(_np.cov(subdata, rowvar=0))
            subdata_start += len_subdata

    n = len(data[0])
    for item in data:
        if len(item) != n:
            raise ValueError("all chains must have equal length")

    data = [_np.asarray(d) for d in data]

    if indices is None:
        indices = _np.arange(data[0].shape[1])
    if len(indices) == 0:
        raise ValueError("``indices`` must be a non-empty iterable, got %s"
                         % (indices,))

    chain_groups = r_group(
        [_np.mean(chain_values.T[indices], axis=1) for chain_values in data],
        [_np.var(chain_values.T[indices], axis=1, ddof=1) for chain_values in data],
        n,
        critical_r,
        approx,
    )

    long_patches_means = []
    long_patches_covs = []
    for group in chain_groups:
        k_g = len(group)
        if K_g >= k_g:
            # distribute K_g patches over the k_g chains in the group
            parts = _part(K_g, k_g)
            for i, chain_index in enumerate(group):
                data_full_chain = data[chain_index]
                this_patch_lengths = _part(len(data_full_chain), parts[i])
                append_components(
                    long_patches_means, long_patches_covs, data_full_chain,
                    this_patch_lengths,
                )
        else:
            # form one long chain out of the group and partition it
            data_full_chain = _np.vstack([data[i] for i in group])
            this_patch_lengths = _part(len(data_full_chain), K_g)
            append_components(
                long_patches_means, long_patches_covs, data_full_chain,
                this_patch_lengths,
            )

    return long_patches_means, long_patches_covs


def make_r_gaussmix(data, K_g=15, critical_r=2.0, indices=None, approx=False):
    """Use ``data`` from multiple chains to form a Gaussian mixture via the
    "long patches" approach of [BC13]: group chains by R value
    (:func:`r_group`), split each group into ``K_g`` patches and give each
    patch's empirical mean/covariance to a Gaussian component.
    (Reference: ``r_value.py:202-248``.)"""
    return _mkgauss(*_make_r_patches(data, K_g, critical_r, indices, approx))


def make_r_tmix(data, K_g=15, critical_r=2.0, dof=5.0, indices=None, approx=False):
    """Like :func:`make_r_gaussmix` but with Student-t components of the
    given ``dof`` (> 2), with sigma rescaled by ``(dof-2)/dof`` so each
    component keeps the patch covariance.
    (Reference: ``r_value.py:251-305``.)"""
    assert dof > 2.0, "finite-covariance Student-t needs dof > 2, got %g" % dof

    means, covs = _make_r_patches(data, K_g, critical_r, indices, approx)

    sigmas = _np.asarray(covs)
    sigmas *= (dof - 2.0) / dof  # cov = dof / (dof - 2) * sigma

    return _mkt(means, sigmas, [dof] * len(means))
