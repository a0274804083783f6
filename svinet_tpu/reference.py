"""Plain float32 reference of one link-sampling sweep.

The engine runs this update blocked, padded, fused and sharded
(svi/linksampling.py:_sweep_body over svi/sweep_math.py, and the mesh
programs in parallel/mesh.py). This module states it once in plain
``jax.numpy`` with none of that machinery, so that the CPU tests and
``chip_smoke.py`` can hold every layout to the same answer.

One sweep (reference: src/linksampling.cc:526-545, 605-749):

  Elogpi  = psi(gamma) - psi(rowsum gamma);  Elogbeta likewise for lambda
  phi_e   = softmax_k(Elogpi[p] + Elogpi[q] + Elogbeta[:, 0])  per link e=(p,q)
  gacc    = sum of phi_e added to rows p and q;  sumk = 2 sum_e phi_e
  mphi    = gacc / (2 deg)  (0 for nodes without training links)
  gamma'  = alpha + gacc + (n - 2 deg - 1) mphi, each row scaled by
            ones / sumk (per column) while annealing
  lambda0 = eta0 + sumk
  lambda1 = eta1 + s1^2 - s2 - s3, with s1 = sum_p mphi, s2 = sum_p mphi^2,
            s3 = sum_e mphi[p] mphi[q]

``mphi_prev`` gives the one-sweep-lagged s3 of ``-fuse-s3`` (and of the
``-mesh-locality`` layout, which always fuses): s3 is then taken over the
previous sweep's indicators instead of this sweep's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Tolerances for comparing an engine sweep with this reference. Both run
# float32; GPU scatter-adds are atomics and mesh layouts psum partial sums,
# so every sum is taken in another (and run-to-run varying) order.
GAMMA_RTOL = 1e-4     # gamma rows are sums of deg phi values, each > alpha
LAM0_RTOL = 1e-4      # lambda0 = eta0 + a sum over all training links
# lambda1 = eta1 + s1^2 - s2 - s3 is a difference of large terms that
# nearly cancel, so its error is bounded absolutely, relative to the size
# of the largest term, max_k s1_k^2. s1 sums n terms; a tree-ordered
# float32 sum of n=1M terms errs by ~log2(n) * 6e-8 ~ 1.2e-6 relative,
# 2.4e-6 for s1^2. 1e-5 leaves room for that and still fails a 1% error
# in s3 (s3 is ~0.6% of s1^2 on the tests' planted graph, so such an error
# moves lambda1 by ~6e-5 of max s1^2).
LAM1_S1SQ_TOL = 1e-5


class ReferenceSweep(NamedTuple):
    gamma: jax.Array    # (n, K)
    lam: jax.Array      # (K, 2)
    mphi: jax.Array     # (n, K) mean indicators of this sweep
    s1: jax.Array       # (K,)


def reference_sweep(gamma, lam, edges, deg, alpha: float, eta, ones: float,
                    annealing: bool, mphi_prev=None,
                    chunk: Optional[int] = None) -> ReferenceSweep:
    """One sweep over the unpadded training links ``edges`` (E, 2).

    deg: (n,) training degree. ``chunk`` splits the edge list into
    consecutive slices of that many links, each the same unpadded
    expression; it exists only so that an (E, K) intermediate too large
    for the device can be bounded. Runs on the default device of the
    caller's context."""
    with jax.default_matmul_precision("highest"):
        gamma = jnp.asarray(gamma, jnp.float32)
        lam = jnp.asarray(lam, jnp.float32)
        edges = np.asarray(edges)
        deg = jnp.asarray(deg, jnp.float32)
        eta = np.asarray(eta, np.float32)
        n, k = gamma.shape
        digamma = jax.scipy.special.digamma
        elogpi = digamma(gamma) - digamma(gamma.sum(1, keepdims=True))
        elogbeta = digamma(lam) - digamma(lam.sum(1, keepdims=True))
        step = max(len(edges), 1) if chunk is None else chunk
        slices = [edges[i:i + step] for i in range(0, len(edges), step)]

        gacc = jnp.zeros((n, k), jnp.float32)
        sumk = jnp.zeros(k, jnp.float32)
        for e in slices:
            p, q = jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1])
            phi = jax.nn.softmax(elogpi[p] + elogpi[q] + elogbeta[:, 0],
                                 axis=-1)
            gacc = gacc.at[p].add(phi).at[q].add(phi)
            sumk = sumk + 2.0 * phi.sum(0)

        two_deg = 2.0 * deg[:, None]
        linked = two_deg > 0
        mphi = jnp.where(linked, gacc / jnp.where(linked, two_deg, 1.0), 0.0)
        gnew = alpha + gacc + (n - two_deg - 1.0) * mphi
        if annealing:
            gnew = jnp.where(linked, gnew * (ones / sumk), gnew)

        m3 = mphi if mphi_prev is None else jnp.asarray(mphi_prev,
                                                         jnp.float32)
        s3 = jnp.zeros(k, jnp.float32)
        for e in slices:
            s3 = s3 + (m3[e[:, 0]] * m3[e[:, 1]]).sum(0)
        s1 = mphi.sum(0)
        s2 = (mphi * mphi).sum(0)
        lam_new = jnp.stack([eta[0] + sumk, eta[1] + s1 * s1 - s2 - s3], 1)
        return ReferenceSweep(gnew, lam_new, mphi, s1)


def sweep_errors(gamma, lam, ref: ReferenceSweep) -> dict:
    """Errors of an engine sweep's (gamma, lam) against the reference, each
    beside its tolerance: {name: (error, tolerance)}."""
    g = np.asarray(gamma, np.float64)
    lm = np.asarray(lam, np.float64)
    rg = np.asarray(ref.gamma, np.float64)
    rl = np.asarray(ref.lam, np.float64)
    s1sq = float(np.max(np.asarray(ref.s1, np.float64) ** 2))
    return {
        "gamma_rel": (float(np.max(np.abs(g - rg) / np.abs(rg))),
                      GAMMA_RTOL),
        "lam0_rel": (float(np.max(np.abs(lm[:, 0] - rl[:, 0])
                                  / np.abs(rl[:, 0]))), LAM0_RTOL),
        "lam1_abs/max_s1sq": (float(np.max(np.abs(lm[:, 1] - rl[:, 1])))
                              / max(s1sq, 1e-30), LAM1_S1SQ_TOL),
    }


def check_sweep(gamma, lam, ref: ReferenceSweep, what: str = "sweep"
                ) -> dict:
    """sweep_errors, raising AssertionError when any error exceeds its
    tolerance (or is not finite)."""
    errs = sweep_errors(gamma, lam, ref)
    bad = {name: v for name, v in errs.items()
           if not np.isfinite(v[0]) or v[0] > v[1]}
    if bad:
        raise AssertionError(f"{what} differs from the plain reference: "
                             + ", ".join(f"{name} {e:.3g} > {t:g}"
                                         for name, (e, t) in bad.items()))
    return errs
