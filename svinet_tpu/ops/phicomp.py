"""Batched per-pair local step (phi fixed point).

The reference's PhiComp runs, for ONE pair at a time, a coupled Jacobi
fixed point on (phi1, phi2) until the mean absolute change falls below
meanchangethresh or online_iterations rounds pass
(reference: PhiComp::update_phis / update_phis_until_conv,
src/mmsbinfer.hh:105-199):

  phi1'_k = softmax_k( Elogpi[p,k] + Elogf_k*phi2_k + [y=1](1-phi2_k)*log(eps) )
  phi2'_k = softmax_k( Elogpi[q,k] + Elogf_k*phi1_k + [y=1](1-phi1_k)*log(eps) )
  Elogf_k = y*Elogbeta[k,0] + (1-y)*Elogbeta[k,1]
            (reference: PhiComp::compute_Elogf, src/mmsbinfer.hh:140-151)

Both updates read the pre-round phi of the partner (Jacobi, not Gauss-
Seidel — the reference stores phinext and copies after both updates).

Vectorized design: run the fixed point for a whole block of B pairs at
once — two (B,K) softmaxes per round — inside one
lax.while_loop that exits when EVERY pair in the block has converged.
Converged pairs are fixed points of the update, so extra rounds leave
them bit-stable; the batched loop computes the same phis as the
reference's per-pair early exit.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def phi_fixed_point(elogpi_p: jax.Array, elogpi_q: jax.Array,
                    elogbeta: jax.Array, y: jax.Array, log_eps: float,
                    max_iters: int = 50, thresh: float = 1e-5
                    ) -> Tuple[jax.Array, jax.Array]:
    """Solve the coupled phi fixed point for B pairs simultaneously.

    elogpi_p/elogpi_q: (B,K) gathered rows of Elogpi for the endpoints.
    elogbeta: (K,2). y: (B,) int. Returns (phi1, phi2), each (B,K).
    """
    b, k = elogpi_p.shape
    yf = (y == 1)[:, None]
    elogf = jnp.where(yf, elogbeta[:, 0], elogbeta[:, 1])  # (B,K)

    phi0 = jnp.full((b, k), 1.0 / k, elogpi_p.dtype)

    def round_(state):
        i, phi1, phi2, _ = state
        u1 = jnp.where(yf, (1.0 - phi2) * log_eps, 0.0)
        n1 = jax.nn.softmax(elogpi_p + elogf * phi2 + u1, axis=-1)
        u2 = jnp.where(yf, (1.0 - phi1) * log_eps, 0.0)
        n2 = jax.nn.softmax(elogpi_q + elogf * phi1 + u2, axis=-1)
        change = jnp.maximum(jnp.abs(n1 - phi1).mean(-1),
                             jnp.abs(n2 - phi2).mean(-1)).max()
        return i + 1, n1, n2, change

    def cond(state):
        i, _, _, change = state
        return (i < max_iters) & (change >= thresh)

    _, phi1, phi2, _ = jax.lax.while_loop(
        cond, round_, (0, phi0, phi0, jnp.asarray(jnp.inf, elogpi_p.dtype)))
    return phi1, phi2
