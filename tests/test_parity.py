"""Golden statistical-parity tests against the reference's bundled runs.

The reference ships actual output directories for its example datasets
(reference: example/*.tgz; SURVEY §6). These tests rerun the headline
configs and assert the statistical results land within Monte-Carlo error
of the recorded values:

  LFR n=1000 k=28 link-sampling: NMI 0.897/0.904, nshol -0.111 @ 43 iters
"""

import numpy as np
import pytest

from svinet_tpu.cli import parse_args
from svinet_tpu.graph import Network


@pytest.mark.parametrize("seed", [1, 2])
def test_lfr_linksampling_nmi_parity(tmp_path, lfr_paths, seed, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = parse_args([
        "-file", lfr_paths["network"], "-n", "1000", "-k", "28",
        "-link-sampling", "-nmi", lfr_paths["ground_truth"],
        "-seed", str(seed), "-label", "parity",
        "-max-iterations", "120",
    ])
    net = Network(cfg)
    net.read(cfg.datfname)
    from svinet_tpu.svi.linksampling import LinkSampling
    eng = LinkSampling(cfg, net)
    eng.infer()

    # NMI parity: reference mutual.txt records 0.897 final / 0.904 best;
    # with the 2x training-link-count semantics this implementation lands
    # at 0.996 (seed 1) / 0.963 (seed 2) / 0.944 (seed 3) — band pinned
    # to the measured multi-seed envelope so a silent regression of the
    # load-bearing sweep semantics fails here
    nmis = [float(line.split()[-1])
            for line in open(cfg.file_str("mutual.txt"))]
    assert max(nmis) >= 0.95, f"NMI too low: {max(nmis)}"

    # heldout nshol parity: reference max.txt records -0.1110; measured
    # seeds 1-3 reach -0.1107 / -0.1124 / -0.1143 (max.txt col 5)
    maxrow = open(cfg.file_str("max.txt")).read().split()
    best_nshol = float(maxrow[4])
    assert -0.116 < best_nshol < -0.105, f"nshol out of range: {best_nshol}"

    # the annealing exit is the second load-bearing semantic
    # (CLAUDE.md hard-won facts): at defaults seed 1 leaves the
    # annealing phase at iteration 72-73 (README sensitivity table:
    # 39-74 across 2x knob variations); pin its studied range
    if seed == 1:
        import re
        log = open(cfg.file_str("infer.log")).read()
        m = re.search(r"annealing ended at iteration (\d+)", log)
        assert m, "seed 1 never left the annealing phase"
        assert 55 <= int(m.group(1)) <= 90, \
            f"annealing exit {m.group(1)} outside studied range"


def test_lfr_fused_s3(tmp_path, lfr_paths, monkeypatch):
    """-fuse-s3 (one-sweep-lagged s3 cross-moment, README Roofline) must
    hold the same statistical parity bands as the default path: the lag
    only perturbs lambda1's correction term during the transient and
    vanishes at the fixed point."""
    monkeypatch.chdir(tmp_path)
    cfg = parse_args([
        "-file", lfr_paths["network"], "-n", "1000", "-k", "28",
        "-link-sampling", "-fuse-s3", "-nmi", lfr_paths["ground_truth"],
        "-seed", "1", "-label", "fuseds3", "-max-iterations", "120",
    ])
    net = Network(cfg)
    net.read(cfg.datfname)
    from svinet_tpu.svi.linksampling import LinkSampling
    eng = LinkSampling(cfg, net)
    eng.infer()
    nmis = [float(line.split()[-1])
            for line in open(cfg.file_str("mutual.txt"))]
    assert max(nmis) >= 0.95, f"NMI too low: {max(nmis)}"
    maxrow = open(cfg.file_str("max.txt")).read().split()
    best_nshol = float(maxrow[4])
    assert -0.116 < best_nshol < -0.105, f"nshol out of range: {best_nshol}"


def test_astroph_linksampling_40iter_parity(tmp_path, monkeypatch):
    """ca-AstroPh headline config, 40-iteration horizon — the cheap
    deterministic variant that runs in the DEFAULT suite (the full
    150-iteration run below stays slow-marked). Measured at this
    horizon: best nshol -0.00922 (seed 1) / -0.00868 (seed 2), already
    inside the rebuilt reference's FINAL envelope (-0.0089..-0.0092,
    BASELINE.md), so a regression of the sweep math or the annealing
    schedule fails here without RUN_SLOW."""
    monkeypatch.chdir(tmp_path)
    cfg = parse_args([
        "-file", "/root/reference/example/ca-AstroPh.csv",
        "-n", "17903", "-k", "20", "-link-sampling",
        "-heldout-ratio", "0.02", "-seed", "1", "-label", "astro40",
        "-max-iterations", "40", "-rfreq", "10",
    ])
    net = Network(cfg)
    net.read(cfg.datfname)
    from svinet_tpu.svi.linksampling import LinkSampling
    eng = LinkSampling(cfg, net)
    eng.infer()
    maxrow = open(cfg.file_str("max.txt")).read().split()
    best_nshol = float(maxrow[4])
    assert best_nshol > -0.0105, f"nshol regressed: {best_nshol}"


@pytest.mark.slow
def test_astroph_linksampling_parity(tmp_path, monkeypatch):
    """ca-AstroPh n=17903 k=20 link-sampling, heldout 2% — the headline
    config. The reference rebuilt on this machine reaches best nshol
    -0.0089..-0.0092 across seeds (BASELINE.md); ours has landed around
    -0.0088 and must stay better than -0.0105 here. Marked slow
    (several minutes on the CPU mesh); run with RUN_SLOW=1."""
    monkeypatch.chdir(tmp_path)
    cfg = parse_args([
        "-file", "/root/reference/example/ca-AstroPh.csv",
        "-n", "17903", "-k", "20", "-link-sampling",
        "-heldout-ratio", "0.02", "-seed", "1", "-label", "astro",
        "-max-iterations", "150",
    ])
    net = Network(cfg)
    net.read(cfg.datfname)
    from svinet_tpu.svi.linksampling import LinkSampling
    eng = LinkSampling(cfg, net)
    eng.infer()
    maxrow = open(cfg.file_str("max.txt")).read().split()
    best_nshol = float(maxrow[4])
    assert best_nshol > -0.0105, f"nshol regressed: {best_nshol}"


def test_assort_batch_likelihood_parity(tmp_path, assort_path, monkeypatch):
    """assort-75-4 batch run: reference converges to validation avg
    ~-0.349 (42 links, 42 nonlinks split at heldout_ratio 0.1)."""
    monkeypatch.chdir(tmp_path)
    cfg = parse_args([
        "-file", assort_path, "-n", "75", "-k", "4", "-batch",
        "-heldout-ratio", "0.1", "-eta-type", "fromdata",
        "-seed", "3", "-label", "parity", "-max-iterations", "100",
        "-no-stop",
    ])
    cfg.alpha = 0.025   # the bundled run's param.txt value
    net = Network(cfg)
    net.read(cfg.datfname)
    from svinet_tpu.svi.mmsb import MMSBInfer
    eng = MMSBInfer(cfg, net)
    eng.batch_infer()
    last = open(cfg.file_str("validation.txt")).readlines()[-1].split()
    avg = float(last[2])
    assert avg > -0.50, f"validation avg logL too low: {avg}"


def test_assort_batch_elbo_parity(tmp_path, assort_path, monkeypatch):
    """assort-75-4 batch -logl: the reference's approximate ELBO converges
    to -11889.39 by iter 84 (reference: example/n75-k4-mmsb-batch.tgz
    logl.txt; src/mmsbinfer.cc:1947-2083). Different random init and
    heldout split shift the final value by a few percent; assert the
    trace is increasing and lands in a band around the golden value."""
    monkeypatch.chdir(tmp_path)
    cfg = parse_args([
        "-file", assort_path, "-n", "75", "-k", "4", "-batch",
        "-heldout-ratio", "0.1", "-eta-type", "fromdata", "-logl",
        "-seed", "3", "-label", "elbo", "-max-iterations", "60",
        "-no-stop",
    ])
    cfg.alpha = 0.025
    net = Network(cfg)
    net.read(cfg.datfname)
    from svinet_tpu.svi.mmsb import MMSBInfer
    eng = MMSBInfer(cfg, net)
    eng.batch_infer()
    rows = [line.split() for line in open(cfg.file_str("logl.txt"))]
    elbos = [float(r[2]) for r in rows]
    assert len(elbos) >= 10
    # increasing overall (coordinate ascent) and near the golden -11889
    assert elbos[-1] > elbos[0]
    assert -13500 < elbos[-1] < -10500, f"final ELBO {elbos[-1]}"


def test_lfr_findk_parity(tmp_path, lfr_paths, monkeypatch):
    """-findk (k=n label propagation) on LFR n=1000: the reference
    rebuilt on this machine estimates K=13 (ground truth is 28 — the
    reference's label-prop systematically underestimates on LFR, and
    parity means matching its behavior). Ours lands at 12 with the same
    config (reference: src/fastinit.cc:240-287)."""
    monkeypatch.chdir(tmp_path)
    cfg = parse_args([
        "-file", lfr_paths["network"], "-n", "1000", "-k", "1000",
        "-findk", "-seed", "1", "-label", "fk",
    ])
    net = Network(cfg)
    net.read(cfg.datfname)
    from svinet_tpu.svi.fastinit import FastInit
    eng = FastInit(cfg, net)
    eng.batch_infer()
    k_est = len([l for l in open(cfg.file_str("communities.txt"))
                 if l.strip()])
    assert 8 <= k_est <= 18, f"estimated K {k_est} far from reference's 13"


def test_lfr_bf16_rows(tmp_path, lfr_paths, monkeypatch):
    """-bf16 (half-width gathered rows, f32 accumulation) must hold the
    LFR parity bands. bf16 engages only AFTER annealing — measured in
    round 4: bf16 wobble during annealing stalls the plateau exit from
    iter ~76 to ~394; with the gating seed 1 lands NMI 0.996 /
    nshol -0.1104, matching f32 exactly."""
    monkeypatch.chdir(tmp_path)
    import re
    cfg = parse_args([
        "-file", lfr_paths["network"], "-n", "1000", "-k", "28",
        "-link-sampling", "-fuse-s3", "-bf16", "-nmi",
        lfr_paths["ground_truth"], "-seed", "1", "-label", "bf16",
        "-max-iterations", "120",
    ])
    net = Network(cfg)
    net.read(cfg.datfname)
    from svinet_tpu.svi.linksampling import LinkSampling
    eng = LinkSampling(cfg, net)
    eng.infer()
    nmis = [float(line.split()[-1])
            for line in open(cfg.file_str("mutual.txt"))]
    assert max(nmis) >= 0.95, f"NMI too low: {max(nmis)}"
    maxrow = open(cfg.file_str("max.txt")).read().split()
    best_nshol = float(maxrow[4])
    assert -0.116 < best_nshol < -0.105, f"nshol out of range: {best_nshol}"
    log = open(cfg.file_str("infer.log")).read()
    m = re.search(r"annealing ended at iteration (\d+)", log)
    assert m and int(m.group(1)) <= 90, \
        "bf16 must not stall the annealing exit (f32 during annealing)"


def test_sparse_w_full_width_matches_dense():
    """-sparse-w with W = K: the 2W union covers every column (each id
    twice, duplicates masked), so one sparse sweep must equal one dense
    -fuse-s3 sweep exactly (same lagged-s3 semantics)."""
    import jax.numpy as jnp
    from svinet_tpu.svi.linksampling import (
        linksampling_fused_multi_sweep, linksampling_sparse_multi_sweep)
    from svinet_tpu.svi.sweep_math import LSConsts
    rng = np.random.default_rng(0)
    n, k, E, block = 48, 6, 128, 64
    p = rng.integers(0, n - 1, E)
    q = rng.integers(1, n, E)
    q = np.where(q <= p, p + 1, q)
    edges = jnp.asarray(np.stack([p, q], 1).astype(np.int32))
    mask = jnp.asarray(np.ones(E, np.float32))
    deg = np.zeros(n, np.float32)
    np.add.at(deg, p, 1)
    np.add.at(deg, q, 1)
    gamma_np = rng.gamma(1.0, 1.0, (n, k)).astype(np.float32)
    lam_np = np.tile([1.0, 1.0], (k, 1)).astype(np.float32)
    mphi_np = rng.uniform(0, 0.2, (n, k)).astype(np.float32)
    gamma = jnp.asarray(gamma_np)
    lam = jnp.asarray(lam_np)
    mphi = jnp.asarray(mphi_np)
    consts = LSConsts(jnp.float32(1.0 / k),
                      jnp.asarray([1.0, 1.0], jnp.float32),
                      jnp.float32(E), jnp.float32(n))
    ann = jnp.float32(0.0)
    gd, ld, md = linksampling_fused_multi_sweep(
        gamma, lam, mphi, edges, mask, jnp.asarray(deg), consts, ann,
        E // block, 2)
    z = jnp.zeros(1, jnp.float32)
    gs, ls, ms = linksampling_sparse_multi_sweep(
        jnp.asarray(gamma_np), jnp.asarray(lam_np),
        jnp.asarray(mphi_np), edges, mask, jnp.asarray(deg),
        consts, ann, z, z, z, jnp.float32(1e-30), E // block, 2, k, 0)
    np.testing.assert_allclose(np.asarray(gs), np.asarray(gd),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ls), np.asarray(ld),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(ms), np.asarray(md),
                               rtol=2e-5, atol=2e-5)


def test_lfr_sparse_w(tmp_path, lfr_paths, monkeypatch):
    """-sparse-w 8 at K=28 on LFR: the top-W union sweep (the
    reference's active-list pruning regime) must hold the statistical
    parity bands — post-anneal each node's active list is far narrower
    than 8, so the union covers the mass."""
    monkeypatch.chdir(tmp_path)
    cfg = parse_args([
        "-file", lfr_paths["network"], "-n", "1000", "-k", "28",
        "-link-sampling", "-sparse-w", "8", "-nmi",
        lfr_paths["ground_truth"], "-seed", "1", "-label", "sparsew",
        "-max-iterations", "120",
    ])
    net = Network(cfg)
    net.read(cfg.datfname)
    from svinet_tpu.svi.linksampling import LinkSampling
    eng = LinkSampling(cfg, net)
    assert cfg.sparse_w == 8
    eng.infer()
    nmis = [float(line.split()[-1])
            for line in open(cfg.file_str("mutual.txt"))]
    assert max(nmis) >= 0.95, f"NMI too low: {max(nmis)}"
    maxrow = open(cfg.file_str("max.txt")).read().split()
    best_nshol = float(maxrow[4])
    assert -0.118 < best_nshol < -0.104, f"nshol out of range: {best_nshol}"
