"""Dirichlet/Beta expectation primitives.

The reference's core primitive is ``set_dir_exp``:
E[log pi]_ik = psi(gamma_ik) - psi(sum_k gamma_ik), a digamma over rows
(reference: src/linksampling.hh:170-201, src/mmsbinfer.hh:550-581 — a
GSL scalar loop there; here a single fused XLA kernel).
"""

from __future__ import annotations

import jax


def dirichlet_expectation(x: jax.Array) -> jax.Array:
    """E[log p] for rows of Dirichlet/Beta variational parameters.

    Works for gamma (n,K) and lambda (K,T) alike; reduction over the last
    axis. XLA emits a single fused kernel for digamma(x) -
    digamma(rowsum); no hand-written kernel is needed.
    """
    return jax.scipy.special.digamma(x) - jax.scipy.special.digamma(
        x.sum(axis=-1, keepdims=True))


def dirichlet_mean(x: jax.Array) -> jax.Array:
    """Point estimate E[p]_k = x_k / sum(x) over the last axis
    (reference: LinkSampling::estimate_pi, src/linksampling.hh:204-214)."""
    return x / x.sum(axis=-1, keepdims=True)
