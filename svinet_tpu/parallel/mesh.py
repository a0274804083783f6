"""Multi-chip data parallelism over edge shards.

The reference's only parallelism is a pthread map-reduce over minibatch
pairs with thread-local sufficient statistics and a serial reduce
(reference: PhiRunner, src/mmsbinfer.cc:2400-2550, reduce at
src/mmsbinfer.cc:1770-1827). The design here: a 1-D device mesh,
training links sharded across chips with shard_map, gamma/lambda
replicated, and the per-shard sufficient statistics (gacc (n,K),
sumk (K,), s3 (K,)) psum-reduced across devices. Step-size/iteration state is
derived from the step index, so replicas stay consistent with zero extra
communication.

For n*K too large to replicate, gamma rows can additionally be sharded
(parameter sharding) — see make_rowsharded_sweep below. The CLI exposes
the edge-data-parallel path as `-mesh N` (svi/linksampling.py).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svinet_tpu.svi.sweep_math import (
    LSConsts, phi_pass, mean_indicator_update, s3_pass, finish_lambda,
    fused_phi_s3_pass,
)


def make_mesh(n_devices: int = 0, axis: str = "edges") -> Mesh:
    devs = jax.devices()
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_edges(edges: np.ndarray, n_shards: int, block: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Split an (E,2) edge list into n_shards equal padded shards.

    Returns (edges (n_shards*Es, 2), mask (n_shards*Es,)) laid out so a
    PartitionSpec('edges') split gives each device a contiguous shard.
    """
    per = -(-len(edges) // n_shards)  # ceil
    per = max(block, ((per + block - 1) // block) * block)
    out = np.zeros((n_shards * per, 2), np.int32)
    mask = np.zeros(n_shards * per, np.float32)
    idx = np.array_split(np.arange(len(edges)), n_shards)
    for s, ids in enumerate(idx):
        out[s * per: s * per + len(ids)] = edges[ids]
        mask[s * per: s * per + len(ids)] = 1.0
    return out, mask


def make_sharded_sweep(mesh: Mesh, num_blocks_per_shard: int,
                       axis: str = "edges") -> Callable:
    """Build the jitted multi-chip link-sampling sweep.

    Signature matches the single-chip sweep: (gamma, lam, edges, mask, deg,
    consts, annealing) -> (gamma', lam'). gamma/lam/deg replicated; edges and
    mask sharded on the leading axis.
    """

    def _local(gamma, lam, edges, mask, deg, consts, annealing):
        from svinet_tpu.ops.expectations import dirichlet_expectation
        elogpi = dirichlet_expectation(gamma)
        elogbeta = dirichlet_expectation(lam)
        gacc, sumk = phi_pass(elogpi, elogbeta[:, 0], edges, mask,
                              num_blocks_per_shard)
        # the ONLY cross-chip traffic: psum of the sufficient statistics
        gacc = jax.lax.psum(gacc, axis)
        sumk = jax.lax.psum(sumk, axis)
        gnext, mphi, s1, s2, lam0 = mean_indicator_update(
            gacc, sumk, deg, consts, annealing)
        s3 = jax.lax.psum(s3_pass(mphi, edges, mask, num_blocks_per_shard),
                          axis)
        return gnext, finish_lambda(s1, s2, s3, lam0, consts)

    sharded = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(),
                  LSConsts(P(), P(), P(), P()), P()),
        out_specs=(P(), P()),
        check_vma=False)
    return jax.jit(sharded, donate_argnums=(0, 1))


def make_sharded_multi_sweep(mesh: Mesh, num_blocks_per_shard: int,
                             axis: str = "edges") -> Callable:
    """n_sweeps sharded sweeps fused into ONE device program: shard_map
    around a lax.fori_loop whose body is the per-shard sweep with psum'd
    sufficient statistics (the collectives run inside the loop every
    iteration; one host round trip per report interval).

    call(..., ho=(pairs, y, w, eps, nb)) additionally returns the six
    validation heldout sums computed on the FINAL state as the tail of
    the same program (gamma is replicated, so every shard computes the
    identical sums — no collective): a report boundary costs one
    dispatch instead of sweep-then-eval, like the single-device paths."""

    @functools.lru_cache(maxsize=None)
    def build(n_sweeps: int, bf16_on: bool, ho_blocks: int):
        def _local(gamma, lam, edges, mask, deg, consts, annealing, *ho):
            import jax.numpy as jnp
            from svinet_tpu.ops.expectations import dirichlet_expectation

            def body(_, state):
                g, l = state
                elogpi = dirichlet_expectation(g)
                if bf16_on:
                    # -bf16: half-width gathered rows, f32 accumulation
                    # (same contract as the single-device sweep)
                    elogpi = elogpi.astype(jnp.bfloat16)
                elogbeta = dirichlet_expectation(l)
                gacc, sumk = phi_pass(elogpi, elogbeta[:, 0], edges, mask,
                                      num_blocks_per_shard)
                gacc = jax.lax.psum(gacc, axis)
                sumk = jax.lax.psum(sumk, axis)
                gnext, mphi, s1, s2, lam0 = mean_indicator_update(
                    gacc, sumk, deg, consts, annealing)
                if bf16_on:
                    mphi = mphi.astype(jnp.bfloat16)
                s3 = jax.lax.psum(
                    s3_pass(mphi, edges, mask, num_blocks_per_shard), axis)
                return gnext, finish_lambda(s1, s2, s3, lam0, consts)

            g, l = jax.lax.fori_loop(0, n_sweeps, body, (gamma, lam))
            if ho_blocks:
                from svinet_tpu.evals.likelihood import heldout_sums_blocked
                hp, hy, hw, eps = ho
                return g, l, heldout_sums_blocked(g, l, hp, hy, hw, eps,
                                                  ho_blocks)
            return g, l

        base_in = (P(), P(), P(axis), P(axis), P(),
                   LSConsts(P(), P(), P(), P()), P())
        ho_in = (P(), P(), P(), P()) if ho_blocks else ()
        sharded = jax.shard_map(
            _local, mesh=mesh,
            in_specs=base_in + ho_in,
            out_specs=(P(), P()) + ((P(),) if ho_blocks else ()),
            check_vma=False)
        return jax.jit(sharded, donate_argnums=(0, 1))

    def call(gamma, lam, edges, mask, deg, consts, annealing,
             n_sweeps: int, bf16_now: bool = False, ho=None):
        if ho is None:
            return build(int(n_sweeps), bool(bf16_now), 0)(
                gamma, lam, edges, mask, deg, consts, annealing)
        hp, hy, hw, eps, nb = ho
        return build(int(n_sweeps), bool(bf16_now), int(nb))(
            gamma, lam, edges, mask, deg, consts, annealing,
            hp, hy, hw, eps)

    return call


def make_sharded_fused_multi_sweep(mesh: Mesh, num_blocks_per_shard: int,
                                   axis: str = "edges",
                                   bf16: bool = False) -> Callable:
    """-fuse-s3 variant of make_sharded_multi_sweep: phi stats and the
    one-sweep-lagged s3 cross-moment in a single pass over the local
    edge shard via packed [Elogpi | mphi] rows (parity
    pinned by tests/test_parity.py::test_lfr_fused_s3). Carries the
    replicated mphi between sweeps. bf16 stores the packed rows
    half-width (-bf16); the edge pass casts back to f32 post-gather.
    call(..., ho=(pairs, y, w, eps, nb)) appends the heldout-sums tail
    (see make_sharded_multi_sweep)."""
    import jax.numpy as jnp

    @functools.lru_cache(maxsize=None)
    def build(n_sweeps: int, bf16_on: bool, ho_blocks: int):
        def _local(gamma, lam, mphi, edges, mask, deg, consts, annealing,
                   *ho):
            from svinet_tpu.ops.expectations import dirichlet_expectation

            def body(_, state):
                g, l, m = state
                packed = jnp.concatenate(
                    [dirichlet_expectation(g), m], axis=1)
                if bf16_on:
                    packed = packed.astype(jnp.bfloat16)
                elogbeta = dirichlet_expectation(l)
                gacc, sumk, s3 = fused_phi_s3_pass(
                    packed, elogbeta[:, 0], edges, mask,
                    num_blocks_per_shard)
                gacc = jax.lax.psum(gacc, axis)
                sumk = jax.lax.psum(sumk, axis)
                s3 = jax.lax.psum(s3, axis)
                gnext, m_new, s1, s2, lam0 = mean_indicator_update(
                    gacc, sumk, deg, consts, annealing)
                return gnext, finish_lambda(s1, s2, s3, lam0,
                                            consts), m_new

            g, l, m = jax.lax.fori_loop(0, n_sweeps, body,
                                        (gamma, lam, mphi))
            if ho_blocks:
                from svinet_tpu.evals.likelihood import heldout_sums_blocked
                hp, hy, hw, eps = ho
                return g, l, m, heldout_sums_blocked(
                    g, l, hp, hy, hw, eps, ho_blocks)
            return g, l, m

        base_in = (P(), P(), P(), P(axis), P(axis), P(),
                   LSConsts(P(), P(), P(), P()), P())
        ho_in = (P(), P(), P(), P()) if ho_blocks else ()
        sharded = jax.shard_map(
            _local, mesh=mesh,
            in_specs=base_in + ho_in,
            out_specs=(P(), P(), P()) + ((P(),) if ho_blocks else ()),
            check_vma=False)
        return jax.jit(sharded, donate_argnums=(0, 1, 2))

    def call(gamma, lam, mphi, edges, mask, deg, consts, annealing,
             n_sweeps: int, bf16_now: "bool | None" = None, ho=None):
        use = bf16 if bf16_now is None else bool(bf16_now)
        if ho is None:
            return build(int(n_sweeps), use, 0)(
                gamma, lam, mphi, edges, mask, deg, consts, annealing)
        hp, hy, hw, eps, nb = ho
        return build(int(n_sweeps), use, int(nb))(
            gamma, lam, mphi, edges, mask, deg, consts, annealing,
            hp, hy, hw, eps)

    return call


def make_rowsharded_fused_multi_sweep(mesh: Mesh,
                                      num_blocks_per_shard: int,
                                      axis: str = "edges",
                                      bf16: bool = False) -> Callable:
    """-fuse-s3 variant of make_rowsharded_multi_sweep: the local
    [Elogpi | mphi] rows are packed BEFORE the all_gather, so one
    (n/d, 2K) tiled all_gather replaces the two (n, K) gathers of the
    unfused path, and the edge pass computes phi stats and the lagged
    s3 together. Carries the row-sharded mphi between sweeps. bf16
    (-bf16) casts BEFORE the all_gather — halving the collective bytes
    as well as the row-gather bytes."""
    import jax.numpy as jnp

    @functools.lru_cache(maxsize=None)
    def build(n_sweeps: int, bf16_on: bool):
        def _local(gamma, lam, mphi_l, edges, mask, deg, consts,
                   annealing):
            from svinet_tpu.ops.expectations import dirichlet_expectation

            def body(_, state):
                g, l, m_l = state
                local_rows = jnp.concatenate(
                    [dirichlet_expectation(g), m_l], axis=1)
                if bf16_on:
                    local_rows = local_rows.astype(jnp.bfloat16)
                packed = jax.lax.all_gather(local_rows, axis, tiled=True)
                elogbeta = dirichlet_expectation(l)
                gacc_full, sumk, s3_l = fused_phi_s3_pass(
                    packed, elogbeta[:, 0], edges, mask,
                    num_blocks_per_shard)
                sumk = jax.lax.psum(sumk, axis)
                s3 = jax.lax.psum(s3_l, axis)
                gacc = jax.lax.psum_scatter(gacc_full, axis,
                                            scatter_dimension=0,
                                            tiled=True)
                gnext, m_new, s1_l, s2_l, lam0 = mean_indicator_update(
                    gacc, sumk, deg, consts, annealing)
                s1 = jax.lax.psum(s1_l, axis)
                s2 = jax.lax.psum(s2_l, axis)
                return gnext, finish_lambda(s1, s2, s3, lam0,
                                            consts), m_new

            return jax.lax.fori_loop(0, n_sweeps, body,
                                     (gamma, lam, mphi_l))

        sharded = jax.shard_map(
            _local, mesh=mesh,
            in_specs=(P(axis), P(), P(axis), P(axis), P(axis), P(axis),
                      LSConsts(P(), P(), P(), P()), P()),
            out_specs=(P(axis), P(), P(axis)),
            check_vma=False)
        return jax.jit(sharded, donate_argnums=(0, 1, 2))

    def call(gamma, lam, mphi, edges, mask, deg, consts, annealing,
             n_sweeps: int, bf16_now: "bool | None" = None):
        use = bf16 if bf16_now is None else bool(bf16_now)
        return build(int(n_sweeps), use)(gamma, lam, mphi, edges, mask,
                                         deg, consts, annealing)

    return call


def make_mesh_trace_sweep(mesh: Mesh, num_blocks_per_shard: int,
                          fused: bool, rowshard: bool,
                          locality: bool = False,
                          axis: str = "edges") -> Callable:
    """-report-batch for the mesh paths: n_batches report boundaries per
    device dispatch, each r sweeps apart, with the six validation heldout
    sums evaluated at EVERY boundary — the mesh form of
    linksampling_sweep_ho_trace (svi/linksampling.py). One builder covers
    all four sharded layouts (fused x rowshard); with n_batches=1 it is
    the ho-tailed multi-sweep, so every mesh report boundary costs ONE
    dispatch instead of sweep-then-eval.

    Replicated layouts evaluate the sums redundantly per shard (gamma is
    replicated — no collective). Row-sharded gamma instead builds a
    COMPACT pi table of just the heldout-touched rows: each shard
    extracts its owned rows (host-precomputed index `hidx`, Hmax slots
    per shard), one (d*Hmax, K) all_gather replaces the (n, K) gather
    the standalone eval needs, the PAIRS are sharded too, and the six
    sums psum-reduce — the touched-rows form of the reference's
    "only touched nodes" reduce (src/mmsbinfer.cc:1802-1808) applied to
    the eval path.

    locality (-mesh-locality, requires fused+rowshard): the SWEEP's
    collectives shrink to boundary rows only. Each shard's edges index
    the concatenated [owned rows | boundary table] space
    (parallel/locality.py); per sweep it exports just the packed rows
    other shards touch (`exp_idx`), all_gathers the (d*Xmax, 2K) table
    in place of the (n, 2K) gather, and psum_scatters only the
    (d*Xmax, K) boundary gamma_hat contributions, merging them into its
    owned rows — the full touched-rows-only reduce."""
    import jax.numpy as jnp
    assert not locality or (fused and rowshard), \
        "-mesh-locality runs the fused row-sharded sweep"

    @functools.lru_cache(maxsize=None)
    def build(r: int, n_batches: int, bf16_on: bool, ho_blocks: int):
        def _local(gamma, lam, mphi, edges, mask, deg, exp_idx, consts,
                   annealing, hidx, hpairs, hy, hw, eps):
            from svinet_tpu.ops.expectations import dirichlet_expectation
            from svinet_tpu.evals.likelihood import heldout_sums_from_pi

            def sweep(_, state):
                g, l, m = state
                elogbeta = dirichlet_expectation(l)
                if fused:
                    local_rows = jnp.concatenate(
                        [dirichlet_expectation(g), m], axis=1)
                    if bf16_on:
                        local_rows = local_rows.astype(jnp.bfloat16)
                    if locality:
                        rows_per = local_rows.shape[0]
                        exports = jnp.take(local_rows, exp_idx, axis=0,
                                           mode="clip")
                        table = jax.lax.all_gather(exports, axis,
                                                   tiled=True)
                        packed = jnp.concatenate([local_rows, table],
                                                 axis=0)
                    elif rowshard:
                        packed = jax.lax.all_gather(local_rows, axis,
                                                    tiled=True)
                    else:
                        packed = local_rows
                    gacc_full, sumk, s3 = fused_phi_s3_pass(
                        packed, elogbeta[:, 0], edges, mask,
                        num_blocks_per_shard)
                    sumk = jax.lax.psum(sumk, axis)
                    s3 = jax.lax.psum(s3, axis)
                    if locality:
                        bnd = jax.lax.psum_scatter(
                            gacc_full[rows_per:], axis,
                            scatter_dimension=0, tiled=True)
                        gacc = gacc_full[:rows_per].at[exp_idx].add(bnd)
                    elif rowshard:
                        gacc = jax.lax.psum_scatter(
                            gacc_full, axis, scatter_dimension=0,
                            tiled=True)
                    else:
                        gacc = jax.lax.psum(gacc_full, axis)
                    gnext, m_new, s1, s2, lam0 = mean_indicator_update(
                        gacc, sumk, deg, consts, annealing)
                    if rowshard:
                        s1 = jax.lax.psum(s1, axis)
                        s2 = jax.lax.psum(s2, axis)
                    return gnext, finish_lambda(s1, s2, s3, lam0,
                                                consts), m_new
                elogpi_l = dirichlet_expectation(g)
                if bf16_on:
                    elogpi_l = elogpi_l.astype(jnp.bfloat16)
                elogpi = (jax.lax.all_gather(elogpi_l, axis, tiled=True)
                          if rowshard else elogpi_l)
                gacc_full, sumk = phi_pass(elogpi, elogbeta[:, 0], edges,
                                           mask, num_blocks_per_shard)
                sumk = jax.lax.psum(sumk, axis)
                if rowshard:
                    gacc = jax.lax.psum_scatter(
                        gacc_full, axis, scatter_dimension=0, tiled=True)
                else:
                    gacc = jax.lax.psum(gacc_full, axis)
                gnext, mphi_l, s1, s2, lam0 = mean_indicator_update(
                    gacc, sumk, deg, consts, annealing)
                if rowshard:
                    s1 = jax.lax.psum(s1, axis)
                    s2 = jax.lax.psum(s2, axis)
                if bf16_on:
                    mphi_l = mphi_l.astype(jnp.bfloat16)
                mphi_full = (jax.lax.all_gather(mphi_l, axis, tiled=True)
                             if rowshard else mphi_l)
                s3 = jax.lax.psum(
                    s3_pass(mphi_full, edges, mask, num_blocks_per_shard),
                    axis)
                return gnext, finish_lambda(s1, s2, s3, lam0, consts), m

            def batch(state, _):
                g, l, m = jax.lax.fori_loop(0, r, sweep, state)
                beta = l[:, 0] / (l[:, 0] + l[:, 1])
                if rowshard:
                    # gather the heldout-touched gamma rows FIRST, then
                    # normalize — materializing full (n/d, K) pi before
                    # the gather costs an extra n*K/d buffer (2 GB at
                    # the stretch shape) inside the scan
                    rows = jnp.take(g, hidx, axis=0, mode="clip")
                    rows = rows / rows.sum(axis=1, keepdims=True)
                    table = jax.lax.all_gather(rows, axis, tiled=True)
                    sums = jax.lax.psum(
                        heldout_sums_from_pi(table, beta, hpairs, hy, hw,
                                             eps, ho_blocks), axis)
                else:
                    pi_l = g / g.sum(axis=1, keepdims=True)
                    sums = heldout_sums_from_pi(pi_l, beta, hpairs, hy,
                                                hw, eps, ho_blocks)
                return (g, l, m), sums

            (g, l, m), trace = jax.lax.scan(batch, (gamma, lam, mphi),
                                            None, length=n_batches)
            return g, l, m, trace

        row = P(axis) if rowshard else P()
        mspec = row if fused else P()
        expspec = P(axis) if locality else P()
        ho_specs = ((P(axis), P(axis), P(axis), P(axis), P())
                    if rowshard else (P(), P(), P(), P(), P()))
        sharded = jax.shard_map(
            _local, mesh=mesh,
            in_specs=(row, P(), mspec, P(axis), P(axis), row, expspec,
                      LSConsts(P(), P(), P(), P()), P()) + ho_specs,
            out_specs=(row, P(), mspec, P()),
            check_vma=False)
        return jax.jit(sharded, donate_argnums=(0, 1, 2))

    def call(gamma, lam, mphi, edges, mask, deg, consts, annealing, ho,
             r: int, n_batches: int, bf16_now: bool = False,
             exp_idx=None):
        import jax.numpy as jnp
        hidx, hp, hy, hw, eps, nb = ho
        if exp_idx is None:
            exp_idx = jnp.zeros(1, jnp.int32)
        return build(int(r), int(n_batches), bool(bf16_now), int(nb))(
            gamma, lam, mphi, edges, mask, deg, exp_idx, consts,
            annealing, hidx, hp, hy, hw, eps)

    return call


def rowshard_heldout_layout(pairs: np.ndarray, y: np.ndarray, n: int,
                            n_shards: int):
    """Host-side layout for the row-sharded heldout tail: the compact
    pi-row table + sharded pair set consumed by make_mesh_trace_sweep's
    rowshard branch.

    Returns (hidx (d*Hmax,) local-row indices per table slot,
    pairs_sh (d*per, 2) table-slot pairs, y_sh, w_sh, nb) where nb is
    the per-shard scan block count. Slots/pairs are zero-padded
    (weight 0); every real pair's endpoints are remapped to table slots
    so the device never touches node ids."""
    rows_per = n // n_shards
    uniq = np.unique(pairs)
    if len(uniq) == 0:
        uniq = np.zeros(1, pairs.dtype)
    owner = uniq // rows_per
    counts = np.bincount(owner, minlength=n_shards)
    hmax = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(uniq)) - starts[owner]
    slot = (owner * hmax + rank).astype(np.int64)
    hidx = np.zeros(n_shards * hmax, np.int32)
    hidx[slot] = (uniq - owner * rows_per).astype(np.int32)
    mapped = slot[np.searchsorted(uniq, pairs)].astype(np.int32)

    m = len(pairs)
    per = -(-max(m, 1) // n_shards)
    blk = min(1 << 17, max(64, 1 << int(np.ceil(np.log2(per)))))
    nb = -(-per // blk)
    tot = nb * blk
    pp = np.zeros((n_shards * tot, 2), np.int32)
    yy = np.zeros(n_shards * tot, np.int32)
    ww = np.zeros(n_shards * tot, np.float32)
    idx = np.array_split(np.arange(m), n_shards)
    for s, ids in enumerate(idx):
        pp[s * tot: s * tot + len(ids)] = mapped[ids]
        yy[s * tot: s * tot + len(ids)] = y[ids]
        ww[s * tot: s * tot + len(ids)] = 1.0
    return hidx, pp, yy, ww, nb


def global_put(arr, sharding):
    """device_put that also works under multi-process JAX: when the
    sharding spans devices of other processes, build the global jax.Array
    from the locally-addressable shards only (every process holds the
    full host copy — they all ingest the same graph — so the callback
    just slices it). Single-process arrays pass straight to device_put —
    np.asarray on a device-resident array would be a full host readback
    (2 GB for the stretch gamma)."""
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def device_put_sharded_edges(mesh: Mesh, edges: np.ndarray, mask: np.ndarray,
                             axis: str = "edges"):
    spec = NamedSharding(mesh, P(axis))
    return (global_put(edges, spec), global_put(mask, spec))


def device_put_replicated(mesh: Mesh, *arrays):
    spec = NamedSharding(mesh, P())
    return tuple(global_put(a, spec) for a in arrays)


def init_distributed(coordinator: str = "", num_processes: int = 0,
                     process_id: int = 0) -> None:
    """Multi-host bring-up: call once per host, BEFORE anything touches a
    jax backend, then build the mesh over the now-global jax.devices()
    (the reference has no distributed backend — its pthread reduce,
    src/mmsbinfer.cc:1770-1827, is single-address-space; across hosts
    the same psum in the sharded sweeps spans every process's devices). The CLI wires this via -dist-coordinator/-dist-nprocs/
    -dist-procid or the SVINET_DIST_* environment variables."""
    if num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def sharded_nonuniform_weights(g, pairs, y, mask, infthresh: float,
                               axis: str):
    """Sharded form of svi/mmsb.py:nonuniform_weights (-nonuniform -inf,
    reference: MMSBInfer::opt_nonuniform_process,
    src/mmsbinfer.cc:1525-1700): category COUNTS (links / informative
    zeros / non-informative zeros) are psum'd so every kept pair carries
    the GLOBAL count weight, exactly as single-device. The per-sample
    caps stay GLOBAL too: both the single kept non-informative zero
    (n2_max=1, src/mmsbinfer.cc:1571-1572) and the 0.1%
    informative-zero cap select the globally-FIRST pairs in shard order
    via an exclusive cross-shard prefix — per-shard selections can miss
    a category entirely (shard 0 holding no non-informative zero; a
    local 0.1% cap flooring to zero below 1000 pairs/shard).
    Returns (weights, n_proc) with n_proc the GLOBAL processed-pair
    count feeding the rnode scale 3n/(2 n_proc)
    (src/mmsbinfer.cc:571-572); call only inside shard_map over `axis`."""
    import jax.numpy as jnp
    gp = g[pairs[:, 0]]
    gq = g[pairs[:, 1]]
    pip = gp / gp.sum(-1, keepdims=True)
    piq = gq / gq.sum(-1, keepdims=True)
    p_i = jnp.clip((pip * piq).sum(-1), 0.0, 1.0)
    valid = mask > 0
    is_link = (y == 1) & valid
    noninf = (y == 0) & valid & (p_i < infthresh)
    inf = (y == 0) & valid & (p_i >= infthresh)
    f = g.dtype
    nones = jax.lax.psum(is_link.sum(), axis)
    inf_local = inf.sum()
    nz_inf = jax.lax.psum(inf_local, axis)
    nz_noninf = jax.lax.psum(noninf.sum(), axis)
    # GLOBAL 0.1% cap with an exact first-C selection across shards:
    # per-shard caps of the local count floor to zero whenever a shard
    # holds < 1000 informative zeros, silently dropping the whole n3
    # category that single-device keeps. Instead take the global cap of
    # the global count and select the first C informative zeros in shard
    # order via an exclusive cross-shard prefix of the local counts.
    n3_max = (0.001 * nz_inf).astype(jnp.int32)
    me = jax.lax.axis_index(axis)
    shard_ix = jnp.arange(jax.lax.axis_size(axis))

    def global_first(sel, cap):
        """Keep the globally-FIRST `cap` selected pairs in shard order
        (exclusive cross-shard prefix + local cumsum) — a per-shard
        selection can miss the category entirely on the shards that
        matter (e.g. shard 0 holding no non-informative zero)."""
        counts = jax.lax.all_gather(sel.sum().astype(jnp.int32), axis)
        prefix = jnp.where(shard_ix < me, counts, 0).sum()
        return sel & (prefix + jnp.cumsum(sel.astype(jnp.int32)) <= cap)

    sel_noninf = global_first(noninf, 1)          # n2_max = 1
    sel_inf = global_first(inf, n3_max)
    w = (is_link.astype(f) * nones.astype(f)
         + sel_noninf.astype(f) * nz_noninf.astype(f)
         + sel_inf.astype(f) * nz_inf.astype(f))
    # nones is already a global psum; only the per-shard selection
    # counts still need reducing (a double psum here once inflated
    # n_proc by n_devices x nones, shrinking the natural-gradient
    # scale 3n/(2 n_proc) by ~n_devices when links dominate)
    n_proc = nones + jax.lax.psum(sel_noninf.sum() + sel_inf.sum(), axis)
    return w, n_proc


def make_sharded_svi_multi_step(mesh: Mesh, num_blocks_per_shard: int,
                                max_iters: int, thresh: float,
                                infthresh: float = 0.0,
                                nonuniform: bool = False,
                                axis: str = "edges") -> Callable:
    """Sharded natural-gradient SVI steps for the minibatch engines
    (MMSBInfer rpair/rnode/stratified, FastAMM2): minibatch pairs sharded
    across the mesh, gamma/lambda replicated, the per-shard sufficient
    statistics gamma_hat (n,K) and lambda_hat (K,2) psum-reduced — the
    sharded analog of the reference's ONLY parallel path, the pthread
    map-reduce inside MMSBInfer (PhiRunner map at
    src/mmsbinfer.cc:2459-2550, serial reduce at 1770-1827). B steps are
    fused into one program (scan), matching svi_multi_step's signature
    with batch arrays (B, nd*per, ...) sharded on axis 1.

    nonuniform (-nonuniform -inf T, src/mmsbinfer.cc:1525-1700): the
    category COUNTS (links / informative zeros / non-informative zeros)
    are psum'd so every pair is weighted by the GLOBAL count exactly as
    single-device; the per-sample caps stay global (see
    sharded_nonuniform_weights — the 0.1% informative-zero cap selects
    the first C pairs in shard order via a cross-shard prefix)."""

    @functools.lru_cache(maxsize=None)
    def build(n_steps: int, tail_blocks=()):
        def _local(gamma, lam, batch_pairs, batch_y, batch_w, alpha, eta,
                   gscales, lscales, noderhots, rhots, do_lambdas,
                   log_eps, *tail):
            from svinet_tpu.ops.expectations import dirichlet_expectation
            from svinet_tpu.svi.mmsb import pair_block_stats
            import jax.numpy as jnp

            def one(state, xs):
                g, l = state
                pairs, y, w, gs, ls, nr, rt, dl = xs
                elogpi = dirichlet_expectation(g)
                elogbeta = dirichlet_expectation(l)
                if nonuniform and infthresh > 0.0:
                    w, n_proc = sharded_nonuniform_weights(
                        g, pairs, y, w, infthresh, axis)
                    f = g.dtype
                    n = jnp.asarray(g.shape[0], f)
                    dev_scale = 3.0 * n / (2.0 * jnp.maximum(
                        n_proc, 1).astype(f))
                    gs = jnp.where(gs > 0, dev_scale, -gs)
                    ls = jnp.where(ls > 0, dev_scale, -ls)
                elif infthresh > 0.0:
                    gp = g[pairs[:, 0]]
                    gq = g[pairs[:, 1]]
                    pip = gp / gp.sum(-1, keepdims=True)
                    piq = gq / gq.sum(-1, keepdims=True)
                    inf = (pip * piq).max(-1) >= infthresh
                    w = jnp.where((y == 1) | inf, w, 0.0)
                gacc, lacc = pair_block_stats(
                    elogpi, elogbeta, pairs, y, w, num_blocks_per_shard,
                    log_eps, max_iters, thresh)
                # the only cross-chip traffic (the reference's reduce)
                gacc = jax.lax.psum(gacc, axis)
                lacc = jax.lax.psum(lacc, axis)
                g = (1.0 - nr) * g + nr * (alpha + gs * gacc)
                l = jnp.where(dl > 0, (1.0 - rt) * l + rt * (eta + ls * lacc),
                              l)
                return (g, l), None

            (gamma, lam), _ = jax.lax.scan(
                one, (gamma, lam),
                (batch_pairs, batch_y, batch_w, gscales, lscales,
                 noderhots, rhots, do_lambdas))
            if tail_blocks:
                # eval tail (round-4 item 5): gamma is replicated, so
                # every shard computes the identical sums — no collective
                from svinet_tpu.evals.likelihood import multi_heldout_sums
                s = len(tail_blocks)
                tp, ty, tw = tail[:s], tail[s:2 * s], tail[2 * s:3 * s]
                eps = tail[3 * s]
                return gamma, lam, multi_heldout_sums(
                    gamma, lam, tp, ty, tw, eps, tail_blocks)
            return gamma, lam

        s = len(tail_blocks)
        tail_specs = (P(),) * (3 * s + 1) if s else ()
        sharded = jax.shard_map(
            _local, mesh=mesh,
            in_specs=(P(), P(), P(None, axis), P(None, axis), P(None, axis),
                      P(), P(), P(), P(), P(), P(), P(), P()) + tail_specs,
            out_specs=(P(), P()) + ((P(),) if s else ()),
            check_vma=False)
        return jax.jit(sharded, donate_argnums=(0, 1))

    def call(gamma, lam, batch_pairs, batch_y, batch_w, alpha, eta,
             gscales, lscales, noderhots, rhots, do_lambdas, log_eps,
             n_steps: int, tail=None):
        if tail is None:
            return build(int(n_steps))(
                gamma, lam, batch_pairs, batch_y, batch_w, alpha, eta,
                gscales, lscales, noderhots, rhots, do_lambdas, log_eps)
        tp, ty, tw, tnb, eps = tail
        return build(int(n_steps), tuple(tnb))(
            gamma, lam, batch_pairs, batch_y, batch_w, alpha, eta,
            gscales, lscales, noderhots, rhots, do_lambdas, log_eps,
            *tp, *ty, *tw, eps)

    return call


def make_sharded_batch_step(mesh: Mesh, num_blocks_per_shard: int,
                            max_iters: int, thresh: float,
                            axis: str = "edges") -> Callable:
    """Sharded full coordinate-ascent pass for -batch: the all-pairs set
    sharded across the mesh, gamma = alpha + psum(gamma_hat)
    (reference: MMSBInfer::batch_infer, src/mmsbinfer.cc:833-930).
    The returned call accepts tail=(tp, ty, tw, tnb, eps) to append the
    per-report eval sums (see make_sharded_svi_multi_step)."""

    @functools.lru_cache(maxsize=None)
    def build(tail_blocks=()):
        def _local(gamma, lam, pairs, y, w, alpha, eta, do_lambda,
                   log_eps, *tail):
            from svinet_tpu.ops.expectations import dirichlet_expectation
            from svinet_tpu.svi.mmsb import pair_block_stats
            import jax.numpy as jnp
            elogpi = dirichlet_expectation(gamma)
            elogbeta = dirichlet_expectation(lam)
            gacc, lacc = pair_block_stats(
                elogpi, elogbeta, pairs, y, w, num_blocks_per_shard,
                log_eps, max_iters, thresh)
            gacc = jax.lax.psum(gacc, axis)
            lacc = jax.lax.psum(lacc, axis)
            gamma = alpha + gacc
            lam = jnp.where(do_lambda > 0, eta + lacc, lam)
            if tail_blocks:
                from svinet_tpu.evals.likelihood import multi_heldout_sums
                s = len(tail_blocks)
                tp, ty, tw = tail[:s], tail[s:2 * s], tail[2 * s:3 * s]
                return gamma, lam, multi_heldout_sums(
                    gamma, lam, tp, ty, tw, tail[3 * s], tail_blocks)
            return gamma, lam

        s = len(tail_blocks)
        tail_specs = (P(),) * (3 * s + 1) if s else ()
        sharded = jax.shard_map(
            _local, mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis), P(axis),
                      P(), P(), P(), P()) + tail_specs,
            out_specs=(P(), P()) + ((P(),) if s else ()),
            check_vma=False)
        return jax.jit(sharded, donate_argnums=(0, 1))

    def call(gamma, lam, pairs, y, w, alpha, eta, do_lambda, log_eps,
             tail=None):
        if tail is None:
            return build()(gamma, lam, pairs, y, w, alpha, eta,
                           do_lambda, log_eps)
        tp, ty, tw, tnb, eps = tail
        return build(tuple(tnb))(gamma, lam, pairs, y, w, alpha, eta,
                                 do_lambda, log_eps, *tp, *ty, *tw, eps)

    return call


def make_rowsharded_sweep(mesh: Mesh, num_blocks_per_shard: int,
                          axis: str = "edges") -> Callable:
    """Link-sampling sweep with gamma ROW-SHARDED across the mesh — the
    large-n regime (n*K beyond one device's memory; BASELINE stretch config
    n=1M, k=500). Per sweep:

      1. each shard computes Elogpi on its gamma rows (local digamma);
      2. all_gather replicates Elogpi for the edge pass (the only big
         collective, n*K per sweep);
      3. the local edge shard runs the phi pass; gacc is psum-reduced and
         each shard keeps its row slice (reduce of sufficient stats =
         the reference's thread reduce, src/mmsbinfer.cc:1770-1827);
      4. the mean-indicator/nonlink correction is row-local; the s3
         cross-moment needs mphi for arbitrary endpoints, so mphi is
         all_gathered (n*K) and s3 psum-reduced.

    gamma/deg are sharded on axis 0; edges/mask sharded; lam replicated.
    Requires n % mesh_size == 0 (pad rows host-side).
    """

    def _local(gamma, lam, edges, mask, deg, consts, annealing):
        from svinet_tpu.ops.expectations import dirichlet_expectation
        elogpi_l = dirichlet_expectation(gamma)
        elogpi = jax.lax.all_gather(elogpi_l, axis, tiled=True)
        elogbeta = dirichlet_expectation(lam)
        gacc_full, sumk = phi_pass(elogpi, elogbeta[:, 0], edges, mask,
                                   num_blocks_per_shard)
        sumk = jax.lax.psum(sumk, axis)
        # reduce-scatter gacc: each shard keeps only its row slice, at half
        # the traffic of a full psum
        gacc = jax.lax.psum_scatter(gacc_full, axis, scatter_dimension=0,
                                    tiled=True)
        gnext, mphi_l, s1_l, s2_l, lam0 = mean_indicator_update(
            gacc, sumk, deg, consts, annealing)
        s1 = jax.lax.psum(s1_l, axis)
        s2 = jax.lax.psum(s2_l, axis)
        mphi = jax.lax.all_gather(mphi_l, axis, tiled=True)
        s3 = jax.lax.psum(s3_pass(mphi, edges, mask, num_blocks_per_shard),
                          axis)
        lam_new = finish_lambda(s1, s2, s3, lam0, consts)
        return gnext, lam_new

    sharded = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P(axis), P(), P(axis), P(axis), P(axis),
                  LSConsts(P(), P(), P(), P()), P()),
        out_specs=(P(axis), P()),
        check_vma=False)
    return jax.jit(sharded, donate_argnums=(0, 1))


def make_rowsharded_multi_sweep(mesh: Mesh, num_blocks_per_shard: int,
                                axis: str = "edges") -> Callable:
    """n_sweeps row-sharded sweeps fused into one device program (the
    large-n analog of make_sharded_multi_sweep: gamma/deg row-sharded,
    Elogpi all_gathered per sweep, gacc reduce-scattered)."""

    @functools.lru_cache(maxsize=None)
    def build(n_sweeps: int, bf16_on: bool):
        def _local(gamma, lam, edges, mask, deg, consts, annealing):
            import jax.numpy as jnp
            from svinet_tpu.ops.expectations import dirichlet_expectation

            def body(_, state):
                g, l = state
                elogpi_l = dirichlet_expectation(g)
                if bf16_on:
                    # cast BEFORE the all_gather: halves collective bytes
                    # too (same as the fused rowshard variant)
                    elogpi_l = elogpi_l.astype(jnp.bfloat16)
                elogpi = jax.lax.all_gather(elogpi_l, axis, tiled=True)
                elogbeta = dirichlet_expectation(l)
                gacc_full, sumk = phi_pass(elogpi, elogbeta[:, 0], edges,
                                           mask, num_blocks_per_shard)
                sumk = jax.lax.psum(sumk, axis)
                gacc = jax.lax.psum_scatter(gacc_full, axis,
                                            scatter_dimension=0, tiled=True)
                gnext, mphi_l, s1_l, s2_l, lam0 = mean_indicator_update(
                    gacc, sumk, deg, consts, annealing)
                s1 = jax.lax.psum(s1_l, axis)
                s2 = jax.lax.psum(s2_l, axis)
                if bf16_on:
                    mphi_l = mphi_l.astype(jnp.bfloat16)
                mphi = jax.lax.all_gather(mphi_l, axis, tiled=True)
                s3 = jax.lax.psum(
                    s3_pass(mphi, edges, mask, num_blocks_per_shard), axis)
                return gnext, finish_lambda(s1, s2, s3, lam0, consts)

            return jax.lax.fori_loop(0, n_sweeps, body, (gamma, lam))

        sharded = jax.shard_map(
            _local, mesh=mesh,
            in_specs=(P(axis), P(), P(axis), P(axis), P(axis),
                      LSConsts(P(), P(), P(), P()), P()),
            out_specs=(P(axis), P()),
            check_vma=False)
        return jax.jit(sharded, donate_argnums=(0, 1))

    def call(gamma, lam, edges, mask, deg, consts, annealing,
             n_sweeps: int, bf16_now: bool = False):
        return build(int(n_sweeps), bool(bf16_now))(
            gamma, lam, edges, mask, deg, consts, annealing)

    return call
