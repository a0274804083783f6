"""Micro-benchmark: gamma-hat accumulation strategies for the phi sweep.

The link-sampling sweep is gather(Elogpi rows) -> softmax -> ACCUMULATE
phi into gacc (n,K) at both edge endpoints. The accumulate is the open
design question from SURVEY.md section 7 ("scatter-add contention"):
how does XLA lower the scatter-add, and does anything beat it? Candidates:

  nophi   phi compute only (no accumulation)    -- lower bound
  scatter gacc.at[p].add(phi).at[q].add(phi)    -- current phi_pass
  segsum  host-presorted endpoints + jax.ops.segment_sum(sorted=True)
  csr     directed-duplicated edges sorted by src; sorted segment_sum
  onehot  blocked one-hot matmul (f32)
  onehotb same, bf16 inputs / f32 accumulation

On the accelerator the engine was first built for, XLA's scatter-add
won at n=17903/K=20 and at n=100k/K=500, so phi_pass keeps it. On the GPU
the scatter becomes atomics, and that verdict is to be measured again.

Run one process per device; timings end in block_until_ready.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np


def make_problem(n, k, e, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, n - 1, size=e).astype(np.int32)
    q = rng.integers(1, n, size=e).astype(np.int32)
    q = np.where(q <= p, p + 1, q).astype(np.int32)
    edges = np.stack([p, q], 1)
    elogpi = rng.normal(size=(n, k)).astype(np.float32)
    elb0 = rng.normal(size=(k,)).astype(np.float32)
    return edges, elogpi, elb0


def phi_of(elogpi, elb0, p, q):
    return jax.nn.softmax(elogpi[p] + elogpi[q] + elb0, axis=-1)


@jax.jit
def v_nophi(elogpi, elb0, edges):
    phi = phi_of(elogpi, elb0, edges[:, 0], edges[:, 1])
    return phi.sum(axis=0)


@jax.jit
def v_scatter(elogpi, elb0, edges):
    n, k = elogpi.shape
    p, q = edges[:, 0], edges[:, 1]
    phi = phi_of(elogpi, elb0, p, q)
    gacc = jnp.zeros((n, k), jnp.float32).at[p].add(phi).at[q].add(phi)
    return gacc


@jax.jit
def v_scatter_bf16(elogpi_bf16, elb0, edges):
    """elogpi stored bf16: halves the gather traffic; softmax and the
    scatter accumulation stay f32."""
    n, k = elogpi_bf16.shape
    p, q = edges[:, 0], edges[:, 1]
    logits = (elogpi_bf16[p].astype(jnp.float32)
              + elogpi_bf16[q].astype(jnp.float32) + elb0)
    phi = jax.nn.softmax(logits, axis=-1)
    return jnp.zeros((n, k), jnp.float32).at[p].add(phi).at[q].add(phi)


@jax.jit
def v_csr(elogpi, elb0, src_sorted, dst):
    """Directed-duplicated edges sorted by source: the src gather is
    sorted, phi is computed in sorted order (2x the softmax work), and
    the accumulate is a sorted segment_sum — no arbitrary scatter."""
    n, k = elogpi.shape
    phi = jax.nn.softmax(elogpi[src_sorted] + elogpi[dst] + elb0, axis=-1)
    return jax.ops.segment_sum(phi, src_sorted, num_segments=n,
                               indices_are_sorted=True)


@jax.jit
def v_segsum(elogpi, elb0, edges, sorted_ids, edge_of_slot):
    n, k = elogpi.shape
    phi = phi_of(elogpi, elb0, edges[:, 0], edges[:, 1])
    contrib = phi[edge_of_slot]          # (2E,K) rows in node-sorted order
    return jax.ops.segment_sum(contrib, sorted_ids, num_segments=n,
                               indices_are_sorted=True)


@functools.partial(jax.jit, static_argnames=("block", "dtype"))
def v_onehot(elogpi, elb0, edges, mask, block: int, dtype=jnp.float32):
    n, k = elogpi.shape
    e_blocks = edges.reshape(-1, block, 2)
    m_blocks = mask.reshape(-1, block)

    def body(gacc, blk):
        e, m = blk
        p, q = e[:, 0], e[:, 1]
        phi = (phi_of(elogpi, elb0, p, q) * m[:, None]).astype(dtype)
        oh_p = jax.nn.one_hot(p, n, dtype=dtype)
        oh_q = jax.nn.one_hot(q, n, dtype=dtype)
        gacc = gacc + jax.lax.dot(oh_p.T, phi,
                                  preferred_element_type=jnp.float32)
        gacc = gacc + jax.lax.dot(oh_q.T, phi,
                                  preferred_element_type=jnp.float32)
        return gacc, None

    gacc, _ = jax.lax.scan(body, jnp.zeros((n, k), jnp.float32),
                           (e_blocks, m_blocks))
    return gacc


def bench(fn, *args, iters=20):
    out = fn(*args)
    jax.block_until_ready(out)            # compile
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def run(n, k, e, block=1024):
    edges, elogpi, elb0 = make_problem(n, k, e)
    ids = np.concatenate([edges[:, 0], edges[:, 1]])
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    sorted_ids = ids[perm].astype(np.int32)
    edge_of_slot = (perm % e).astype(np.int32)

    ed = jnp.asarray(edges)
    el = jnp.asarray(elogpi)
    eb = jnp.asarray(elb0)
    si = jnp.asarray(sorted_ids)
    es = jnp.asarray(edge_of_slot)

    pad = (-e) % block
    ed_pad = jnp.asarray(np.concatenate(
        [edges, np.zeros((pad, 2), np.int32)]))
    m_pad = jnp.asarray(np.concatenate(
        [np.ones(e, np.float32), np.zeros(pad, np.float32)]))

    results = {}
    results["nophi"] = bench(v_nophi, el, eb, ed)
    results["scatter"] = bench(v_scatter, el, eb, ed)
    el16 = el.astype(jnp.bfloat16)
    results["scatter_bf16"] = bench(v_scatter_bf16, el16, eb, ed)
    # segsum/csr materialize a (2E,K) contribution array in one flat op;
    # skip them where that exceeds device memory (the synth K=500 scale)
    flat_ok = 2 * e * k * 4 < 3 * 1024**3
    if flat_ok:
        results["segsum"] = bench(v_segsum, el, eb, ed, si, es)
        dst = np.concatenate([edges[:, 1], edges[:, 0]])[perm].astype(np.int32)
        dst_d = jnp.asarray(dst)
        results["csr"] = bench(v_csr, el, eb, si, dst_d)
    results["onehot_f32"] = bench(v_onehot, el, eb, ed_pad, m_pad, block,
                                  jnp.float32)
    results["onehot_bf16"] = bench(v_onehot, el, eb, ed_pad, m_pad, block,
                                   jnp.bfloat16)

    print(f"n={n} k={k} E={e} block={block}")
    for name, dt in results.items():
        print(f"  {name:12s} {dt*1e3:8.3f} ms   "
              f"{e/dt/1e6:10.1f} Medges/s")

    # numeric agreement of the candidates vs scatter
    ref = np.asarray(v_scatter(el, eb, ed))
    checks = [
        ("onehot_f32", v_onehot, (el, eb, ed_pad, m_pad, block, jnp.float32)),
        ("onehot_bf16", v_onehot, (el, eb, ed_pad, m_pad, block, jnp.bfloat16))]
    if flat_ok:
        checks = [("segsum", v_segsum, (el, eb, ed, si, es)),
                  ("csr", v_csr, (el, eb, si, dst_d))] + checks
    for name, fn, args in checks:
        got = np.asarray(fn(*args))
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
        print(f"  {name:12s} max rel err vs scatter: {err:.2e}")


if __name__ == "__main__":
    import sys
    if len(sys.argv) > 1 and sys.argv[1] == "--synth":
        run(n=100_000, k=500, e=2_000_000, block=2048)
    else:
        run(n=17903, k=20, e=196972, block=1024)
