"""Kernel unit tests: digamma expectations, NMI, likelihood vs numpy/scipy."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.special import digamma as sp_digamma

from svinet_tpu.ops.expectations import dirichlet_expectation, dirichlet_mean
from svinet_tpu.evals.nmi import overlapping_nmi
from svinet_tpu.evals.likelihood import heldout_stats


def test_dirichlet_expectation_matches_scipy():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.01, 10.0, size=(17, 5))
    got = np.asarray(dirichlet_expectation(jnp.asarray(x, jnp.float32)))
    want = sp_digamma(x) - sp_digamma(x.sum(1, keepdims=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_dirichlet_mean():
    x = np.array([[1.0, 3.0], [2.0, 2.0]])
    got = np.asarray(dirichlet_mean(jnp.asarray(x)))
    np.testing.assert_allclose(got, [[0.25, 0.75], [0.5, 0.5]])


def test_nmi_identical_covers():
    cover = [[0, 1, 2], [3, 4, 5], [6, 7, 8, 9]]
    assert overlapping_nmi(cover, cover) == pytest.approx(1.0)


def test_nmi_disjoint_covers_low():
    a = [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]
    b = [[0, 2, 4, 6, 8], [1, 3, 5, 7, 9]]
    v = overlapping_nmi(a, b)
    assert 0.0 <= v < 0.2


def test_nmi_permuted_labels():
    a = [[0, 1, 2], [3, 4, 5]]
    b = [[3, 4, 5], [0, 1, 2]]
    assert overlapping_nmi(a, b) == pytest.approx(1.0)


def test_nmi_symmetry():
    rng = np.random.default_rng(1)
    a = [list(rng.choice(50, size=12, replace=False)) for _ in range(4)]
    b = [list(rng.choice(50, size=9, replace=False)) for _ in range(5)]
    assert overlapping_nmi(a, b) == pytest.approx(overlapping_nmi(b, a))


def test_heldout_likelihood_reference_formula():
    """Check the mixture likelihood against a scalar reimplementation of
    LinkSampling::edge_likelihood (src/linksampling.hh:258-292)."""
    rng = np.random.default_rng(3)
    n, k = 12, 4
    eps = 1e-30
    gamma = rng.uniform(0.1, 5.0, size=(n, k))
    lam = rng.uniform(0.5, 8.0, size=(k, 2))
    pairs = np.array([[0, 1], [2, 3], [4, 5], [6, 7]], np.int32)
    ys = np.array([1, 0, 1, 0], np.int32)

    res = heldout_stats(jnp.asarray(gamma, jnp.float32),
                        jnp.asarray(lam, jnp.float32),
                        jnp.asarray(pairs), jnp.asarray(ys), eps)

    pi = gamma / gamma.sum(1, keepdims=True)
    beta = lam[:, 0] / lam.sum(1)
    lls = []
    for (p, q), y in zip(pairs, ys):
        if y == 1:
            s = float((pi[p] * pi[q] * beta).sum())
        else:
            s = 0.0
            for zp in range(k):
                for zq in range(k):
                    rate = beta[zp] if zp == zq else eps
                    s += pi[p][zp] * pi[q][zq] * (1 - rate)
        lls.append(np.log(max(s, 1e-30)))
    lls = np.array(lls)
    # float32 device math vs float64 host math
    assert res.avg == pytest.approx(lls.mean(), rel=1e-3)
    assert res.avg1 == pytest.approx(lls[ys == 1].mean(), rel=1e-3)
    assert res.avg0 == pytest.approx(lls[ys == 0].mean(), rel=1e-3)


def test_converged_of_flags():
    """Exactly one community with gamma-alpha >= 1 freezes the node
    (reference: check_and_set_converged, src/linksampling.cc:456-475)."""
    from svinet_tpu.svi.sweep_math import converged_of
    alpha = 0.25
    gamma = jnp.asarray([
        [5.0, 0.3, 0.3],    # one active -> frozen to k=0
        [5.0, 4.0, 0.3],    # two active -> not frozen
        [0.3, 0.3, 0.3],    # none active -> not frozen
        [0.3, 0.3, 9.0],    # one active -> frozen to k=2
    ], jnp.float32)
    c = np.asarray(converged_of(gamma, jnp.float32(alpha)))
    assert c.tolist() == [1, 0, 0, 3]


def test_phi_pass_one_sided_freeze_hard_assigns():
    """A pair with exactly ONE frozen endpoint contributes a one-hot of
    weight 1 to both endpoints; both-frozen and both-free pairs use the
    soft phi (reference fast path, src/linksampling.cc:618-631)."""
    from svinet_tpu.svi.sweep_math import phi_pass, converged_of
    rng = np.random.default_rng(0)
    n, k = 6, 3
    alpha = 0.1
    gamma = np.full((n, k), 0.5, np.float32)
    gamma[0, 1] = 7.0                        # node 0 frozen to k=1
    elogpi = rng.normal(size=(n, k)).astype(np.float32)
    elb0 = rng.normal(size=(k,)).astype(np.float32)
    edges = np.array([[0, 3], [4, 5]], np.int32)   # frozen-free, free-free
    mask = np.ones(2, np.float32)
    conv = converged_of(jnp.asarray(gamma), jnp.float32(alpha))
    gacc, sumk = phi_pass(jnp.asarray(elogpi), jnp.asarray(elb0),
                          jnp.asarray(edges), jnp.asarray(mask), 1, conv)
    gacc = np.asarray(gacc)
    # edge (0,3): hard one-hot at k=1 on both endpoints
    np.testing.assert_allclose(gacc[0], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(gacc[3], [0, 1, 0], atol=1e-6)
    # edge (4,5): plain softmax
    want = np.exp(elogpi[4] + elogpi[5] + elb0)
    want /= want.sum()
    np.testing.assert_allclose(gacc[4], want, atol=1e-5)
    np.testing.assert_allclose(gacc[5], want, atol=1e-5)
    assert float(sumk.sum()) == pytest.approx(4.0, abs=1e-5)


def _dead_column_state(n=40, k=24, ka=5, seed=0):
    """Synthetic state where only ka columns carry mass: the regime the
    active-K compaction (-prune) targets. Dead columns sit at alpha
    (their pruned-sweep fixed point) so compaction is exact."""
    rng = np.random.default_rng(seed)
    alpha = 1.0 / k
    gamma = np.full((n, k), alpha, np.float32)
    gamma[:, :ka] = rng.gamma(4.0, 2.0, size=(n, ka))
    lam = np.tile([1.0, 1.0], (k, 1)).astype(np.float32)
    lam[:ka] = rng.gamma(5.0, 3.0, size=(ka, 2))
    edges = rng.integers(0, n, size=(64, 2)).astype(np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    pad = 64 - len(edges)
    mask = np.concatenate([np.ones(len(edges), np.float32),
                           np.zeros(pad, np.float32)])
    edges = np.concatenate([edges, np.zeros((pad, 2), np.int32)])
    deg = np.zeros(n, np.float32)
    np.add.at(deg, edges[: 64 - pad, 0], 1)
    np.add.at(deg, edges[: 64 - pad, 1], 1)
    return gamma, lam, edges, mask, deg, alpha


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_compact_sweep_matches_dense(fused):
    """A sweep at the compacted width must equal the dense sweep on the
    active columns, with inactive columns at their (alpha, eta) fixed
    point (the -prune correctness contract)."""
    import jax
    from svinet_tpu.svi.sweep_math import LSConsts
    from svinet_tpu.svi.linksampling import (
        _sweep_body, _fused_sweep_body, compact_columns, expand_columns)
    from svinet_tpu.svi.sweep_math import (
        compact_sweep_body, compact_fused_sweep_body)

    n, k, ka = 40, 24, 5
    gamma, lam, edges, mask, deg, alpha = _dead_column_state(n, k, ka)
    eta = jnp.asarray([1.0, 1.0], jnp.float32)
    consts = LSConsts(alpha=jnp.float32(alpha), eta=eta,
                      ones=jnp.float32(mask.sum()),
                      n_nodes=jnp.float32(n))
    g_d, l_d = jnp.asarray(gamma), jnp.asarray(lam)
    e_d, m_d = jnp.asarray(edges), jnp.asarray(mask)
    deg_d = jnp.asarray(deg)
    ann = jnp.float32(0.0)

    kpad = 8
    idx = np.full(kpad, k, np.int32)
    idx[:ka] = np.arange(ka)
    colmask = jnp.asarray((np.arange(kpad) < ka).astype(np.float32))
    idx_d = jnp.asarray(idx)
    rest = jnp.float32((k - ka) * alpha)
    gc, lc = compact_columns(g_d, l_d, idx_d, colmask,
                             consts.alpha, consts.eta, kpad)

    if fused:
        mphi = jnp.asarray(
            np.random.default_rng(1).uniform(0, 0.2, (n, k)), jnp.float32)
        mphi = mphi.at[:, ka:].set(0.0)   # dead columns have no indicators
        g1, l1, mp1 = _fused_sweep_body(g_d, l_d, mphi, e_d, m_d, deg_d,
                                        consts, ann, 1)
        mc = jnp.where(colmask[None, :] > 0,
                       jnp.take(mphi, idx_d, axis=1, mode="clip"), 0.0)
        g2c, l2c, mp2c = compact_fused_sweep_body(
            gc, lc, mc, e_d, m_d, deg_d, consts, rest, colmask, 1)
    else:
        g1, l1 = _sweep_body(g_d, l_d, e_d, m_d, deg_d, consts, ann, 1)
        g2c, l2c = compact_sweep_body(gc, lc, e_d, m_d, deg_d, consts,
                                      rest, colmask, 1)
    g2, l2 = expand_columns(g2c, l2c, idx_d, consts.alpha, consts.eta, k)

    # dense sweep of a dead-column state leaves those columns ~(alpha,eta)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2),
                               rtol=2e-3, atol=2e-3)
    if fused:
        mp2 = jnp.zeros((n, k), jnp.float32).at[:, idx_d].set(
            mp2c, mode="drop")
        np.testing.assert_allclose(np.asarray(mp1), np.asarray(mp2),
                                   rtol=2e-4, atol=2e-4)


def test_compact_expand_roundtrip():
    from svinet_tpu.svi.linksampling import compact_columns, expand_columns
    n, k, ka, kpad = 13, 24, 5, 8
    gamma, lam, *_ , alpha = _dead_column_state(n, k, ka, seed=3)
    eta = jnp.asarray([1.0, 1.0], jnp.float32)
    idx = np.full(kpad, k, np.int32)
    idx[:ka] = np.arange(ka)
    colmask = jnp.asarray((np.arange(kpad) < ka).astype(np.float32))
    gc, lc = compact_columns(jnp.asarray(gamma), jnp.asarray(lam),
                             jnp.asarray(idx), colmask,
                             jnp.float32(alpha), eta, kpad)
    g2, l2 = expand_columns(gc, lc, jnp.asarray(idx), jnp.float32(alpha),
                            eta, k)
    np.testing.assert_allclose(np.asarray(g2), gamma, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(l2), lam, rtol=1e-6)


def test_converged_of_sticky_prev():
    """The reference's _converged is assigned when active_comms == 1 and
    NEVER cleared (src/linksampling.cc:472-473: prune() only overwrites
    on a later count==1 state). converged_of(prev=...) must keep a
    frozen node frozen when a second column later crosses the
    threshold, and update the column on a new count==1 state."""
    import jax.numpy as jnp
    from svinet_tpu.svi.sweep_math import converged_of
    alpha = 0.25
    g1 = jnp.asarray([[2.0, 0.3, 0.3],     # converged to column 0
                      [0.3, 0.3, 0.3],     # free
                      [2.0, 2.0, 0.3]])    # two active: free
    c1 = converged_of(g1, alpha)
    assert list(np.asarray(c1)) == [1, 0, 0]
    # node 0 gains a second active column; node 1 converges to column 2
    g2 = jnp.asarray([[2.0, 2.0, 0.3],
                      [0.3, 0.3, 2.0],
                      [2.0, 2.0, 0.3]])
    c2 = converged_of(g2, alpha, c1)
    assert list(np.asarray(c2)) == [1, 3, 0]   # node 0 STAYS frozen
    # stateless call (no prev) thaws node 0 — the pre-round-4 behavior
    assert list(np.asarray(converged_of(g2, alpha))) == [0, 3, 0]
    # a later count==1 state re-points the frozen column
    g3 = jnp.asarray([[0.3, 2.0, 0.3],
                      [0.3, 0.3, 2.0],
                      [2.0, 2.0, 0.3]])
    c3 = converged_of(g3, alpha, c2)
    assert list(np.asarray(c3)) == [2, 3, 0]
