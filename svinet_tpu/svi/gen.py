"""MMSBGen — network generation, posterior predictive checks, GML export.

JAX re-design of the reference's MMSBGen (reference:
src/mmsbgen.cc):

- gen (-gen): draw pi ~ Dir(alpha) (alpha=0.05, src/main.cc:277),
  beta_k ~ Beta(eta0_gen, eta1_gen); for every pair draw membership
  indicators z_p ~ Cat(pi_p), z_q ~ Cat(pi_q) and
  y ~ Bern(beta_k) if z_p == z_q == k else Bern(eps)
  (src/mmsbgen.cc:43-71, draw_and_save src/mmsbgen.cc:662-697).
  Emits network_gen.dat, pi-gen.txt, beta-gen.txt, groups.txt, summary.txt.
- ppc (-ppc): load gamma.txt/lambda.txt from cwd (src/mmsbgen.cc:73-149),
  compute observed stats, then ppc_ndraws replicated networks with
  pi ~ Dir(gamma), beta ~ Beta(lambda) (draw_all, src/mmsbgen.cc:900-911);
  compare ones-density / avg deg / max deg / local clustering coeff and
  per-link-community log-pe + size via z-scores
  (src/mmsbgen.cc:151-178, 287-330). Local clustering is computed natively
  (the reference shells out to SNAP's nstat, src/mmsbgen.cc:560-573).
- gml (-gml): node attrs group/bridgeness/influence/degree, each edge
  colored by argmax_k pi_p pi_q beta when the normalized max > 0.9
  (src/mmsbgen.cc:910-961; inner_prod_max src/matrix.hh:459-476;
  bridgeness = (1-sqrt(sum (pi-1/K)^2 K/(K-1))) * deg,
  src/fastamm2.cc:2061-2073).

The O(n^2) pair loop becomes row-blocked categorical draws on device:
a (R,n,K) logits tensor per block, two categorical samples, and a
Bernoulli mask — all in one jitted program per row block.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from svinet_tpu.config import Config
from svinet_tpu.graph import Network
from svinet_tpu.io.writers import load_model


@functools.partial(jax.jit, static_argnames=("nrows", "n"))
def _gen_rows(key, logpi, beta, eps, row0, nrows: int, n: int):
    """Generate y for pairs (i,j), i in [row0,row0+nrows), j in (i,n).

    logpi: (n,K) log pi. Returns (nrows, n) uint8 adjacency slab."""
    rows = row0 + jnp.arange(nrows)
    k1, k2, k3 = jax.random.split(key, 3)
    lp_rows = logpi[rows]                                    # (R,K)
    zp = jax.random.categorical(
        k1, lp_rows[:, None, :], axis=-1,
        shape=(nrows, n))                                    # (R,n)
    zq = jax.random.categorical(
        k2, logpi[None, :, :], axis=-1, shape=(nrows, n))    # (R,n)
    rate = jnp.where(zp == zq, beta[zp], eps)
    u = jax.random.uniform(k3, (nrows, n))
    upper = jnp.arange(n)[None, :] > rows[:, None]           # j > i only
    return ((u < rate) & upper).astype(jnp.uint8)


def draw_network(key, pi: np.ndarray, beta: np.ndarray, eps: float,
                 row_block: int = 0) -> np.ndarray:
    """Draw a full network; returns (E,2) int32 canonical edges."""
    n, k = pi.shape
    if row_block == 0:
        row_block = max(1, min(n, (1 << 24) // max(n * k, 1) + 1))
    logpi = jnp.asarray(np.log(np.maximum(pi, 1e-300)), jnp.float32)
    beta_d = jnp.asarray(beta, jnp.float32)
    out = []
    for row0 in range(0, n, row_block):
        nrows = min(row_block, n - row0)
        slab = _gen_rows(jax.random.fold_in(key, row0), logpi, beta_d,
                         jnp.float32(eps), jnp.int32(row0),
                         nrows=row_block, n=n)
        slab = np.asarray(slab[:nrows])
        ii, jj = np.nonzero(slab)
        out.append(np.stack([ii + row0, jj], axis=1))
    edges = np.concatenate(out, axis=0).astype(np.int32)
    return edges


def draw_network_sparse(rng: np.random.Generator, pi: np.ndarray,
                        beta: np.ndarray, eps: float) -> np.ndarray:
    """Sparse a-MMSB draw for large n — never enumerates the n^2 pairs.

    Per-community Poisson thinning (the Ball-Karrer-Newman Poisson
    multigraph construction): community k contributes
    m_k ~ Poisson(beta_k * (S_k^2 - sum_p pi_pk^2) / 2) candidate edges,
    each endpoint drawn iid proportional to pi[:,k]; self-loops dropped,
    duplicates deduped. For the small per-pair rates the generator is
    used with (beta_k * pi_pk * pi_qk << 1), this matches the reference's
    exact Bernoulli pair draw (reference: MMSBGen::draw_and_save,
    src/mmsbgen.cc:662-697) to O(rate^2). The epsilon cross-community
    term is ignored; with the default eps=1e-30 its expected edge count
    is ~0 on any graph that fits in memory (asserted below).

    Returns (E,2) int32 canonical (p<q) deduped edges.
    """
    n, k = pi.shape
    total_pairs = n * (n - 1) / 2.0
    if eps * total_pairs > 0.5:
        raise ValueError(
            f"sparse generator ignores the eps cross term but "
            f"eps*pairs = {eps * total_pairs:.2g} expected edges")
    out = []
    pi64 = pi.astype(np.float64, copy=False)
    s = pi64.sum(axis=0)
    t = (pi64 * pi64).sum(axis=0)
    lam = np.maximum(beta * (s * s - t) / 2.0, 0.0)
    m = rng.poisson(lam)
    for c in range(k):
        if m[c] == 0:
            continue
        cdf = np.cumsum(pi64[:, c])
        draws = np.searchsorted(
            cdf, rng.random(2 * int(m[c])) * cdf[-1], side="right")
        draws = np.minimum(draws, n - 1).astype(np.int32)
        p, q = draws[::2], draws[1::2]
        keep = p != q
        p, q = p[keep], q[keep]
        out.append(np.stack([np.minimum(p, q), np.maximum(p, q)], axis=1))
    if not out:
        return np.zeros((0, 2), np.int32)
    edges = np.concatenate(out, axis=0)
    keys = edges[:, 0].astype(np.int64) * n + edges[:, 1]
    _, idx = np.unique(keys, return_index=True)
    return edges[np.sort(idx)]


def _draw_edges(rng: np.random.Generator, key, pi: np.ndarray,
                beta: np.ndarray, eps: float) -> np.ndarray:
    """Beyond ~64k nodes the dense per-pair draw is infeasible (the
    reference's generator is O(n^2), src/mmsbgen.cc:662-697); the sparse
    Poisson-thinned draw scales to n=1M."""
    if pi.shape[0] > 65536:
        print(f"+ sparse generator (n={pi.shape[0]} > 65536)")
        return draw_network_sparse(rng, pi, beta, eps)
    return draw_network(key, pi, beta, eps)


def draw_planted(rng: np.random.Generator, key, n: int, k: int,
                 eta0_gen: float, eta1_gen: float, disjoint: bool,
                 eps: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The a-MMSB draw of -gen: pi ~ Dir(0.05) (src/main.cc:277 hardcodes
    the gen alpha), beta_k ~ Beta(eta0_gen, eta1_gen), then the links.
    Returns (pi (n,K), beta (K,), edges (E,2) canonical p<q)."""
    pi = rng.dirichlet(np.full(k, 0.05), size=n)
    beta = rng.beta(eta0_gen, eta1_gen, size=k)
    if disjoint:
        # disjoint memberships: every pair draw uses the node's most
        # likely group (reference: draw_membership_indicators disjoint
        # branch, src/mmsbgen.hh:151-170)
        hard = np.eye(k)[pi.argmax(1)]
        pi = 0.999 * hard + 0.001 / k
    return pi, beta, _draw_edges(rng, key, pi, beta, eps)


def local_clustering_avg(n: int, edges: np.ndarray) -> float:
    """Average local clustering coefficient, computed natively (the
    reference shells out to SNAP nstat). Triangle counting via sorted
    adjacency-set intersection per edge."""
    if len(edges) == 0:
        return 0.0
    deg = np.zeros(n, np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    nbrs = [[] for _ in range(n)]
    for p, q in edges:
        nbrs[p].append(q)
        nbrs[q].append(p)
    nbrs = [np.sort(np.array(v, np.int64)) for v in nbrs]
    tri = np.zeros(n, np.float64)
    for p, q in edges:
        common = np.intersect1d(nbrs[p], nbrs[q], assume_unique=True)
        c = len(common)
        tri[p] += c
        tri[q] += c
    denom = deg * (deg - 1)
    cc = np.where(denom > 0, tri / np.maximum(denom, 1), 0.0)
    return float(cc.mean())


@jax.jit
def _edge_colors(pi, beta, edges):
    """inner_prod_max per edge: (max_k of pi_p pi_q beta) / sum, argmax
    (reference: src/matrix.hh:459-476). Also returns the un-normalized
    sum s (the pair's link probability under pi/beta — the ppc pe term)
    so callers don't re-dispatch the same gather eagerly."""
    prod = pi[edges[:, 0]] * pi[edges[:, 1]] * beta
    s = prod.sum(-1)
    amax = prod.argmax(-1)
    mx = jnp.take_along_axis(prod, amax[:, None], 1)[:, 0]
    return amax.astype(jnp.int32), mx / jnp.maximum(s, 1e-30), s


def _edge_colors_padded(pi_d, beta_d, pairs_np):
    """_edge_colors over a host edge array, padded to a power-of-two
    block so the jitted program compiles once per size BUCKET, not once
    per distinct edge count — ppc feeds ~100 differently-sized replicated
    draws, which otherwise retrace per draw. Padding pairs are (0,0); the
    slices drop them."""
    m = int(pairs_np.shape[0])
    padded = max(1024, 1 << int(np.ceil(np.log2(max(m, 1)))))
    pp = np.zeros((padded, 2), np.int32)
    pp[:m] = pairs_np
    colors, mx, s = _edge_colors(pi_d, beta_d, jnp.asarray(pp))
    return (np.asarray(colors)[:m], np.asarray(mx)[:m],
            np.asarray(s)[:m])


def bridgeness(pi: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """(1 - sqrt(sum (pi-1/K)^2 * K/(K-1))) * deg
    (reference: src/fastamm2.cc:2061-2073)."""
    n, k = pi.shape
    v = ((pi - 1.0 / k) ** 2).sum(1) * k / (k - 1)
    return (1.0 - np.sqrt(v)) * deg


class MMSBGen:
    """Host driver for -gen / -ppc / -gml / -lcstats."""

    def __init__(self, cfg: Config, network: Optional[Network] = None):
        self.cfg = cfg
        self.network = network
        self.key = jax.random.PRNGKey(cfg.seed)
        self.n = cfg.n if network is None else network.n
        self.k = cfg.k

    # ------------------------------------------------------------------
    def gen(self) -> None:
        """-gen: a-MMSB generator; with -orig the full-blockmodel variant
        (K x K beta, diag ~ Beta(eta_gen), off-diag = eps; reference:
        MMSBOrig::gen, src/mmsborig.cc:25-116, alpha = 1/K there,
        src/main.cc:271)."""
        cfg = self.cfg
        cfg.make_outdir()
        rng = np.random.default_rng(cfg.seed)
        if cfg.orig:
            alpha = 1.0 / self.k
            pi = rng.dirichlet(np.full(self.k, alpha), size=self.n)
            beta = rng.beta(cfg.eta0_gen, cfg.eta1_gen, size=self.k)
            # full-blockmodel draw: z_p != z_q pairs link with prob eps.
            # Assortative diag means the a-MMSB sampler with per-k rates
            # beta_k and cross-rate eps generates exactly this model.
            edges = _draw_edges(rng, self.key, pi, beta, cfg.epsilon)
            with open(cfg.file_str("beta-gen-matrix.txt"), "w") as f:
                for g in range(self.k):
                    row = [cfg.epsilon] * self.k
                    row[g] = beta[g]
                    f.write("\t".join(f"{v:.5g}" for v in row) + "\n")
        else:
            pi, beta, edges = draw_planted(
                rng, self.key, self.n, self.k, cfg.eta0_gen, cfg.eta1_gen,
                cfg.disjoint, cfg.epsilon)
        from svinet_tpu.io.native import write_edges_tsv
        if not write_edges_tsv(cfg.file_str("network_gen.dat"),
                               edges.astype(np.int64)):
            with open(cfg.file_str("network_gen.dat"), "w") as f:
                for p, q in edges:
                    f.write(f"{p}\t{q}\n")
        self._save_pi_beta(pi, beta)
        self._write_groups(pi)
        print(f"+ generated network: n={self.n}, ones={len(edges)}")

    def _save_pi_beta(self, pi, beta) -> None:
        cfg = self.cfg
        from svinet_tpu.io.native import write_matrix_tsv
        if not write_matrix_tsv(cfg.file_str("pi-gen.txt"),
                                np.asarray(pi, np.float32), None,
                                decimals=5):
            with open(cfg.file_str("pi-gen.txt"), "w") as f:
                for i in range(self.n):
                    vals = "\t".join(f"{v:.5f}" for v in pi[i])
                    f.write(f"{i}\t{i}\t{vals}\n")
        with open(cfg.file_str("beta-gen.txt"), "w") as f:
            for k in range(self.k):
                f.write(f"{k}\t{beta[k]:.5f}\n")

    def _write_groups(self, pi) -> None:
        cfg = self.cfg
        groups = pi.argmax(1)
        from svinet_tpu.io.native import write_matrix_tsv_extra
        if not write_matrix_tsv_extra(cfg.file_str("groups.txt"),
                                      np.asarray(pi, np.float32), None,
                                      groups, decimals=5):
            with open(cfg.file_str("groups.txt"), "w") as f:
                for i in range(self.n):
                    vals = "\t".join(f"{v:.5f}" for v in pi[i])
                    f.write(f"{i}\t{i}\t{vals}\t{groups[i]}\n")
        with open(cfg.file_str("summary.txt"), "a") as f:
            counts = np.bincount(groups, minlength=self.k)
            f.write("\t".join(str(c) for c in counts) + "\n")

    # ------------------------------------------------------------------
    def _load(self) -> Tuple[np.ndarray, np.ndarray]:
        """gamma.txt/lambda.txt from the cwd (reference: MMSBGen::load_model,
        src/mmsbgen.cc:73-149)."""
        gamma, lam = load_model(".", self.n, self.k, self.cfg.t)
        return gamma, lam

    def ppc(self) -> None:
        cfg = self.cfg
        net = self.network
        gamma, lam = self._load()
        os.makedirs("ppc", exist_ok=True)

        total_pairs = net.total_pairs
        obs_ones = net.ones / total_pairs
        obs_maxd, obs_avgd = net.deg_stats()
        obs_ccf = local_clustering_avg(self.n, net.edges)
        with open("obs-ones.txt", "a") as f:
            f.write(f"{obs_ones:.5f}\n")
        with open("obs-avg-deg.txt", "w") as f:
            f.write(f"{obs_avgd:.5f}\n")
        with open("obs-max-deg.txt", "w") as f:
            f.write(f"{obs_maxd}\n")
        with open("obs-ccf.txt", "w") as f:
            f.write(f"{obs_ccf:.5f}\n")

        rng = np.random.default_rng(cfg.seed)
        nd = cfg.ppc_ndraws
        rep_ones = np.zeros(nd)
        rep_avgd = np.zeros(nd)
        rep_maxd = np.zeros(nd)
        rep_ccf = np.zeros(nd)
        lc_obs_pe = np.zeros((nd, self.k))
        lc_ppc_pe = np.zeros((nd, self.k))
        lc_obs_sz = np.zeros((nd, self.k))
        lc_ppc_sz = np.zeros((nd, self.k))

        obs_edges_d = jnp.asarray(net.edges)
        for d in range(nd):
            pi = np.stack([rng.dirichlet(gamma[i]) for i in range(self.n)])
            beta = rng.beta(lam[:, 0], lam[:, 1])
            edges = draw_network(jax.random.fold_in(self.key, d), pi, beta,
                                 cfg.epsilon)
            rep_ones[d] = len(edges) / total_pairs
            deg = np.zeros(self.n, np.int64)
            if len(edges):
                np.add.at(deg, edges[:, 0], 1)
                np.add.at(deg, edges[:, 1], 1)
            rep_avgd[d] = deg.mean()
            rep_maxd[d] = deg.max() if len(edges) else 0
            rep_ccf[d] = local_clustering_avg(self.n, edges)

            # per-link-community stats under THIS draw's pi/beta
            pi_d = jnp.asarray(pi, jnp.float32)
            beta_d = jnp.asarray(beta, jnp.float32)
            for (pairs, pe, sz) in (
                    (np.asarray(obs_edges_d), lc_obs_pe, lc_obs_sz),
                    (np.asarray(edges) if len(edges) else None,
                     lc_ppc_pe, lc_ppc_sz)):
                if pairs is None or pairs.shape[0] == 0:
                    continue
                colors, mx, pr = _edge_colors_padded(pi_d, beta_d, pairs)
                keep = mx >= 0.5
                ll = np.log(np.maximum(pr, 1e-30))
                for k in range(self.k):
                    sel = keep & (colors == k)
                    sz[d, k] = sel.sum()
                    pe[d, k] = ll[sel].mean() if sel.any() else 0.0
            print(f"ppc draw: {d} / {nd}")

        def _dump(name, arr):
            with open(f"ppc/{name}", "w") as f:
                for v in arr:
                    f.write(f"{v:.5f}\n")

        _dump("ppc-ones.txt", rep_ones)
        _dump("ppc-avg-deg.txt", rep_avgd)
        _dump("ppc-max-deg.txt", rep_maxd)
        _dump("ppc-ccf.txt", rep_ccf)

        def _z(obs, rep):
            sd = rep.std()
            return (obs - rep.mean()) / sd if sd > 0 else 0.0

        with open("ppc/zscores.txt", "w") as f:
            f.write(f"ones\t{_z(obs_ones, rep_ones):.5f}\n")
            f.write(f"avg_deg\t{_z(obs_avgd, rep_avgd):.5f}\n")
            f.write(f"max_deg\t{_z(obs_maxd, rep_maxd):.5f}\n")
            f.write(f"ccf\t{_z(obs_ccf, rep_ccf):.5f}\n")
        with open("ppc/lc_zscores_pe.txt", "w") as f:
            for k in range(self.k):
                f.write(f"{k}\t{_z(lc_obs_pe[:, k].mean(), lc_ppc_pe[:, k]):.5f}\n")
        with open("ppc/lc_zscores_size.txt", "w") as f:
            for k in range(self.k):
                f.write(f"{k}\t{_z(lc_obs_sz[:, k].mean(), lc_ppc_sz[:, k]):.5f}\n")
        print("+ ppc done")

    # ------------------------------------------------------------------
    def gml(self) -> None:
        cfg = self.cfg
        cfg.make_outdir()
        net = self.network
        gamma, lam = self._load()
        pi = gamma / gamma.sum(1, keepdims=True)
        beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
        groups = pi.argmax(1)
        bri = bridgeness(pi, net.deg)

        colors, mx, _ = _edge_colors(jnp.asarray(pi, jnp.float32),
                                     jnp.asarray(beta, jnp.float32),
                                     jnp.asarray(net.edges))
        colors = np.asarray(colors)
        mx = np.asarray(mx)

        # per-community subgraph degrees (influence; reference: community.hh)
        comm_deg = np.zeros((self.n, self.k), np.int64)
        sel = mx >= 0.9
        for (p, q), c in zip(net.edges[sel], colors[sel]):
            comm_deg[p, c] += 1
            comm_deg[q, c] += 1

        with open(cfg.file_str("network.gml"), "w") as f:
            f.write("graph\n[\n\tdirected 0\n")
            for i in range(self.n):
                g = int(groups[i])
                f.write("\tnode\n\t[\n")
                f.write(f"\t\tid {i}\n")
                f.write(f"\t\textid {int(net.seq2id[i])}\n")
                f.write(f"\t\tgroup {g}\n")
                f.write(f"\t\tbridgeness {bri[i]:.5f}\n")
                f.write(f"\t\tinfluence {int(comm_deg[i, g])}\n")
                f.write(f"\t\tdegree {int(net.deg[i])}\n")
                f.write("\t]\n")
            for (p, q), c, m in zip(net.edges, colors, mx):
                if m < 0.9:
                    continue
                f.write("\tedge\n\t[\n")
                f.write(f"\t\tsource {p}\n")
                f.write(f"\t\ttarget {q}\n")
                f.write(f"\t\tcolor {c}\n")
                f.write("\t]\n")
            f.write("]\n")
        # uncolored-links.txt: edges below the 0.9 coloring threshold
        # (reference: MMSBGen::gml, src/mmsbgen.cc:910-961)
        with open(cfg.file_str("uncolored-links.txt"), "w") as f:
            for (p, q), m in zip(net.edges, mx):
                if m < 0.9:
                    f.write(f"{int(net.seq2id[p])}\t{int(net.seq2id[q])}\n")
        # node_bridgeness.txt / node_influence.txt side files
        with open(cfg.file_str("node_bridgeness.txt"), "w") as f:
            for i in range(self.n):
                f.write(f"{i}\t{int(net.seq2id[i])}\t{bri[i]:.5f}\t"
                        f"{int(net.deg[i])}\t{int(groups[i])}\n")
        with open(cfg.file_str("node_influence.txt"), "w") as f:
            for i in range(self.n):
                row = "\t".join(str(int(v)) for v in comm_deg[i])
                f.write(f"{i}\t{int(net.seq2id[i])}\t{row}\n")
        print("+ Done writing GML file. Visualize the communities using "
              "a tool such as Gephi.")

    def get_lc_stats(self) -> None:
        """Link-community stats: per-community degree stats + most
        influential node (reference: MMSBGen::get_lc_stats,
        process_link_communities2, src/mmsbgen.cc:180-193, 673-700)."""
        cfg = self.cfg
        cfg.make_outdir()
        net = self.network
        gamma, lam = self._load()
        pi = gamma / gamma.sum(1, keepdims=True)
        beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
        colors, mx, _ = _edge_colors(jnp.asarray(pi, jnp.float32),
                                     jnp.asarray(beta, jnp.float32),
                                     jnp.asarray(net.edges))
        colors = np.asarray(colors)
        sel = np.asarray(mx) >= 0.5
        comm_deg = np.zeros((self.n, self.k), np.int64)
        for (p, q), c in zip(net.edges[sel], colors[sel]):
            comm_deg[p, c] += 1
            comm_deg[q, c] += 1
        with open(cfg.file_str("community_stats.txt"), "w") as f:
            for k in range(self.k):
                d = comm_deg[:, k]
                nz = d[d > 0]
                avg = nz.mean() if len(nz) else 0.0
                mxd = d.max() if len(nz) else 0
                node = int(d.argmax())
                f.write(f"{k}\t{avg:.5f}\t{float(mxd):.5f}\t{node}\t"
                        f"{int(net.seq2id[node])}\n")
