#!/usr/bin/env python3
"""On-device smoke test of the link-sampling path.

    python chip_smoke.py          # one GPU: phases 0-2
    python chip_smoke.py --four   # four GPUs: the -mesh layouts, nothing else

Phase 0 reports the device. Phase 1 generates a planted graph at the
shape of ca-AstroPh (n=17,903, K=20, ~240k links) with the repo's
generator, runs the CLI's -link-sampling engine in this process to its
stopping rule and checks its outputs and its NMI against the planted
cover; it also compares one sweep of the engine's program with the plain
reference (svinet_tpu/reference.py) run on the host CPU. Phase 2 builds
the n=1M, K=500 (~29M links) state on the device, times three sweeps of
the program the CLI runs at that shape and compares one with the
reference run on the device.

--four runs, on the phase-2 graph, one sweep of each multi-card layout
the engine offers (-mesh 4, -mesh 4 -mesh-rowshard, -mesh 4
-mesh-locality) against the one-card program and the reference, then the
phase-1 CLI run with -mesh 4 against the same run on one card.

Everything runs in this one process, so only one JAX process holds each
card. A failed phase or comparison raises, so the exit code is non-zero,
and there is no CPU fallback. The last line, printed only on success, is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Work files go to .smoke/ in the repo; compiled programs to the cache that
svinet_tpu.cli.configure_compile_cache picks. The phase functions take
their sizes as arguments, so that tests/test_reference.py can rehearse
them small on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.metadata
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")

SEED = 1
ETA_GEN = (3.0, 97.0)         # planted beta_k ~ Beta(3, 97), disjoint
P1_N, P1_K = 17_903, 20       # ca-AstroPh, the reference's largest example
P1_MAX_ITERS = 400
P1_NMI_FLOOR = 0.75           # CPU rehearsal reached 0.8191: see CHANGES.md
P2_N, P2_K = 1_000_000, 500   # the recorded stretch configuration
P2_SWEEPS = 3
REF_CHUNK = 1 << 20           # links per reference slice at K=500
MESH_NMI_TOL = 0.02           # -mesh 4 vs one card: |dNMI|
MESH_NSHOL_RTOL = 0.01        # -mesh 4 vs one card: |d best nshol| / |nshol|

_compiles = {"secs": 0.0, "count": 0, "hits": 0, "written": 0}


def require_gpu(count: int = 1):
    """The devices to run on; refuses anything but `count` or more GPUs."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX's first device is "
                         f"{devs[0].platform!r}")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found "
                         f"{len(devs)}")
    return devs


def _track_compiles() -> None:
    """Count XLA compiles and persistent-cache traffic through JAX's
    monitoring events."""
    from jax import monitoring

    def on_duration(event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            _compiles["secs"] += secs
            _compiles["count"] += 1

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            _compiles["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            _compiles["written"] += 1

    monitoring.register_event_duration_secs_listener(on_duration)
    monitoring.register_event_listener(on_event)


class Phase:
    """A phase's wall time, split into compile (XLA compile seconds from
    the monitoring events), timed windows (device work ended by
    block_until_ready, or a whole CLI run) and host set-up (the rest)."""

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.c0 = dict(_compiles)
        self.windows = {}
        print(f"== {name}", flush=True)

    @contextlib.contextmanager
    def window(self, bucket: str):
        t0, c0 = time.perf_counter(), _compiles["secs"]
        yield
        self.windows[bucket] = self.windows.get(bucket, 0.0) + (
            time.perf_counter() - t0 - (_compiles["secs"] - c0))

    def compiles(self) -> dict:
        return {k: _compiles[k] - self.c0[k] for k in _compiles}

    def done(self) -> None:
        wall = time.perf_counter() - self.t0
        c = self.compiles()
        host = wall - c["secs"] - sum(self.windows.values())
        parts = [f"host set-up {host:.2f} s", f"compile {c['secs']:.2f} s"]
        parts += [f"{k} {v:.2f} s" for k, v in self.windows.items()]
        print(f"{self.name}: wall {wall:.2f} s = " + " + ".join(parts)
              + f" ({c['count']} XLA compiles, persistent cache "
              f"{c['hits']} hits / {c['written']} written)", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def report_errors(what: str, errs: dict) -> None:
    """Print each error beside its tolerance; raise when one exceeds it."""
    bad = []
    for name, (err, tol) in errs.items():
        ok = bool(np.isfinite(err)) and err <= tol
        print(f"  {what}: {name} = {err:.3e} (tolerance {tol:g}) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            bad.append(name)
    if bad:
        raise SystemExit(f"chip_smoke: {what}: {', '.join(bad)} out of "
                         f"tolerance")


def link_sampling_argv(n: int, k: int, label: str, *extra: str) -> list:
    return ["-n", str(n), "-k", str(k), "-link-sampling", "-seed",
            str(SEED), "-label", label, *extra]


def build_engine(argv: list, network=None, edges=None):
    """LinkSampling as cli.main builds it for argv; a network built from
    `edges` (or given, already loaded) replaces the -file read."""
    from svinet_tpu.cli import load_network, parse_args
    from svinet_tpu.svi.linksampling import LinkSampling
    cfg = parse_args(argv)
    if network is None:
        network = load_network(cfg, edges)
    else:
        # what loading the network sets on its own config
        cfg.n = network.n
        cfg.set_eta(network.total_pairs, network.ones)
    return LinkSampling(cfg, network), network


def set_state(eng, gamma, lam, mphi=None) -> None:
    """Put a host start state into the engine's own layout: its sharding,
    plus the padding rows of -mesh-rowshard (gamma at alpha, mphi 0)."""
    import jax

    def place(like, a, fill):
        extra = like.shape[0] - a.shape[0]
        if extra:
            a = np.concatenate([a, np.full((extra,) + a.shape[1:], fill,
                                           a.dtype)])
        return jax.device_put(a, like.sharding)

    eng.gamma = place(eng.gamma, gamma, eng.cfg.alpha)
    eng.lam = place(eng.lam, lam, 0.0)
    if mphi is not None:
        eng.mphi = place(eng.gamma, mphi, 0.0)


def engine_sweep(eng, phase: Phase) -> None:
    """One engine.step(1), the program the CLI runs for this layout,
    timed as device work."""
    import jax
    with phase.window("device"):
        eng.step(1)
        jax.block_until_ready((eng.gamma, eng.lam))


def host_state(eng):
    return np.asarray(eng.gamma)[:eng.n], np.asarray(eng.lam)


def reference_for(net, gamma, lam, mphi_prev=None, chunk=None):
    """The plain reference sweep on the network's training links, with
    the engine's annealing start (annealing on)."""
    from svinet_tpu.reference import reference_sweep
    cfg = net.cfg
    return reference_sweep(
        gamma, lam, net.training_links, net.training_deg.astype(np.float32),
        cfg.alpha, (cfg.eta0, cfg.eta1), float(net.ones), annealing=True,
        mphi_prev=mphi_prev, chunk=chunk)


# ---------------------------------------------------------------------
def phase0(devs, cache_dir: str) -> None:
    import jax
    ph = Phase("phase 0: device")
    d = devs[0]
    print(f"  platform {d.platform}, device_kind {d.device_kind}, "
          f"count {len(devs)}")
    print(f"  bytes_limit {d.memory_stats()['bytes_limit']}")
    plugins = sorted(f"{m.metadata['Name']} {m.version}"
                     for m in importlib.metadata.distributions()
                     if "jax" in (m.metadata["Name"] or "").lower()
                     and "cuda" in (m.metadata["Name"] or "").lower())
    print(f"  jax {jax.__version__}; CUDA plugin: "
          f"{', '.join(plugins) or 'none found'}")
    print(f"  compile cache: {cache_dir}")
    ph.done()


def make_phase1_graph(n: int, k: int, outdir: str):
    """Planted graph as tools/stretch_run.py configures the generator
    (-disjoint, beta ~ Beta(3, 97), seed 1). Returns (edge file, cover)."""
    from svinet_tpu.config import Config
    from svinet_tpu.svi.gen import MMSBGen
    cfg = Config(n=n, k=k, gen=True, seed=SEED, disjoint=True,
                 eta0_gen=ETA_GEN[0], eta1_gen=ETA_GEN[1], outdir=outdir)
    cfg.resolve()
    MMSBGen(cfg).gen()
    # the planted cover in -nmi's format: "node<TAB>community" per node
    groups = np.loadtxt(cfg.file_str("groups.txt"), usecols=(0, k + 2),
                        dtype=np.int64)
    cover = os.path.join(outdir, "planted-cover.txt")
    np.savetxt(cover, groups, fmt="%d", delimiter="\t")
    return cfg.file_str("network_gen.dat"), cover




def enter_work(name: str) -> str:
    """A fresh working directory under .smoke/ (the CLI writes its output
    directory into the cwd)."""
    work = os.path.join(WORK, name)
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    return work


def phase1_argv(edges: str, cover: str, n: int, k: int,
                max_iters: int) -> list:
    return ["-file", edges, "-n", str(n), "-k", str(k), "-link-sampling",
            "-heldout-ratio", "0.02", "-seed", str(SEED), "-nmi", cover,
            "-max-iterations", str(max_iters)]


def run_cli(argv: list, phase: Phase, bucket: str) -> dict:
    """cli.main(argv) in this process; returns what its outputs say."""
    from svinet_tpu.cli import main, parse_args
    outdir = parse_args(list(argv)).outdir
    with phase.window(bucket):
        rc = main(list(argv))
    if rc != 0:
        raise SystemExit(f"chip_smoke: cli.main returned {rc}")

    def rows(name):
        with open(os.path.join(outdir, name)) as f:
            return [line.split() for line in f if line.strip()]

    mx = rows("max.txt")[0]
    nmi = [float(r[-1]) for r in rows("mutual.txt")]
    secs = np.array([float(r[1]) for r in rows("time.txt")])
    return {"gamma_rows": len(rows("gamma.txt")),
            "lambda_rows": len(rows("lambda.txt")),
            "communities": len(rows("communities.txt")),
            "last_iter": int(mx[0]), "best_nshol": float(mx[4]),
            "nmi": nmi[-1] if nmi else float("nan"),
            "median_iter_s": float(np.median(secs[1:] if len(secs) > 1
                                             else secs))}


def phase1(n: int = P1_N, k: int = P1_K, max_iters: int = P1_MAX_ITERS,
           nmi_floor: float = P1_NMI_FLOOR) -> dict:
    import jax
    from svinet_tpu.reference import sweep_errors
    ph = Phase(f"phase 1: CLI -link-sampling at n={n} K={k} to the "
               f"stopping rule")
    work = enter_work("p1")
    edges, cover = make_phase1_graph(n, k, os.path.join(work, "gen"))
    argv = phase1_argv(edges, cover, n, k, max_iters)

    # one sweep of the engine's own program from its start state, against
    # the reference on the host CPU (independent of the GPU's arithmetic)
    eng, net = build_engine(argv + ["-label", "refcheck"])
    g0, l0 = host_state(eng)
    engine_sweep(eng, ph)
    g1, l1 = host_state(eng)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = reference_for(net, g0, l0)
    report_errors("phase 1 linksampling_multi_sweep_ho vs reference (CPU)",
                  sweep_errors(g1, l1, ref))
    n_nodes, n_train = eng.n, len(net.training_links)
    del eng, net
    gc.collect()

    run = run_cli(argv, ph, "cli run (host+device)")
    c = ph.compiles()
    print(f"  compile cache {'warm' if c['hits'] else 'cold'}: "
          f"{c['hits']} hits, {c['written']} written, {c['secs']:.2f} s "
          f"compiling in phase 1")
    stopped = run["last_iter"] < max_iters
    print(f"  n={n_nodes}, training links {n_train}; stopped at iteration "
          f"{run['last_iter']} "
          f"({'stopping rule' if stopped else 'iteration cap'}); best "
          f"nshol {run['best_nshol']:.5f}; NMI {run['nmi']:.4f} (floor "
          f"{nmi_floor}); {run['communities']} communities; median "
          f"{run['median_iter_s']:.6f} s per iteration (sweep and report, "
          f"time.txt)")
    checks = {
        "gamma.txt has n rows": run["gamma_rows"] == n_nodes,
        "lambda.txt has K rows": run["lambda_rows"] == k,
        "communities.txt is non-empty": run["communities"] > 0,
        "best nshol is finite": bool(np.isfinite(run["best_nshol"])),
        "the stopping rule fired": stopped,
        f"NMI >= {nmi_floor}": run["nmi"] >= nmi_floor,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 1 failed: {failed}")
    ph.done()
    return run


def make_stretch_graph(n: int, k: int) -> np.ndarray:
    """The stretch graph, planted like phase 1's through the sparse draw
    directly (MMSBGen.gen would also write a 1M x K groups.txt)."""
    import jax
    from svinet_tpu.svi.gen import draw_planted
    _, _, edges = draw_planted(np.random.default_rng(SEED),
                               jax.random.PRNGKey(SEED), n, k, ETA_GEN[0],
                               ETA_GEN[1], True, 1e-30)
    return edges


def phase2(smi: str, n: int = P2_N, k: int = P2_K,
           sweeps: int = P2_SWEEPS, chunk: int = REF_CHUNK) -> None:
    import jax
    import jax.numpy as jnp
    from svinet_tpu.reference import sweep_errors
    from svinet_tpu.svi.linksampling import linksampling_multi_sweep_ho
    ph = Phase(f"phase 2: {sweeps} sweeps of the CLI's program at n={n} "
               f"K={k}")
    enter_work("p2")
    eng, net = build_engine(link_sampling_argv(n, k, "stretch"),
                            edges=make_stretch_graph(n, k))
    n_train = len(net.training_links)
    print(f"  n={eng.n}, training links {n_train}, {eng.num_blocks} edge "
          f"blocks")
    g0, l0 = jnp.copy(eng.gamma), jnp.copy(eng.lam)

    # the step program compiled ahead of time, for its memory analysis;
    # the engine's own call below reuses this compilation
    hp, hy, hw, nb = eng._ho_dev
    compiled = linksampling_multi_sweep_ho.lower(
        eng.gamma, eng.lam, eng.edges, eng.mask, eng.deg, eng.consts,
        jnp.float32(1.0), hp, hy, hw, jnp.float32(eng.cfg.epsilon),
        eng.num_blocks, 1, nb, False, False, None).compile()
    print(f"  memory_analysis: {compiled.memory_analysis()}")

    secs = []
    for i in range(sweeps):
        before = _compiles["count"]
        t0 = time.perf_counter()
        engine_sweep(eng, ph)
        secs.append(time.perf_counter() - t0)
        if _compiles["count"] != before:
            raise SystemExit("chip_smoke: phase 2 compiled inside its "
                             "timed sweeps")
        if i == 0:
            g1, l1 = jnp.copy(eng.gamma), jnp.copy(eng.lam)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')} of "
          f"bytes_limit {stats.get('bytes_limit')}")
    med = float(np.median(secs))
    print(f"  s/sweep {secs}: median {med:.6f} s/sweep, "
          f"{n_train / med:.6e} edge phi-updates/s [{smi}]")
    del eng
    gc.collect()

    with ph.window("reference (device)"):
        ref = reference_for(net, g0, l0, chunk=chunk)
        jax.block_until_ready(ref)
    report_errors("phase 2 sweep vs reference (device)",
                  sweep_errors(np.asarray(g1), np.asarray(l1), ref))
    ph.done()


# ---------------------------------------------------------------------
def print_layout(eng, name: str, cards: int) -> None:
    """Every card must hold its shard of gamma: print where the shards
    sit and what each card holds."""
    shards = eng.gamma.addressable_shards
    devices = sorted({s.device for s in shards}, key=lambda d: d.id)
    print(f"  {name}: gamma {eng.gamma.shape} as shards "
          f"{sorted({tuple(s.data.shape) for s in shards})} on "
          f"{len(devices)} devices")
    if len(devices) != cards:
        raise SystemExit(f"chip_smoke: {name} holds gamma on "
                         f"{len(devices)} devices, not {cards}")
    for d in devices:
        st = d.memory_stats() or {}
        print(f"    device {d.id}: bytes_in_use {st.get('bytes_in_use')}, "
              f"peak {st.get('peak_bytes_in_use')}")


def four(smi: str, n: int = P2_N, k: int = P2_K, p1_n: int = P1_N,
         p1_k: int = P1_K, max_iters: int = P1_MAX_ITERS,
         chunk: int = REF_CHUNK, cards: int = 4) -> None:
    import jax
    from svinet_tpu.cli import load_network, parse_args
    from svinet_tpu.reference import sweep_errors
    ph = Phase(f"{cards} cards: one sweep of each -mesh layout at n={n} "
               f"K={k}")
    enter_work("four")
    mesh = ["-mesh", str(cards)]
    # one network for every layout: the -mesh-locality reorder is only a
    # permutation of the node ids, and every layout must be right on it
    net = load_network(parse_args(link_sampling_argv(
        n, k, "net", *mesh, "-mesh-locality")), make_stretch_graph(n, k))
    layouts = [  # (name, flags, the one-card program it must match)
        ("one card", [], None),
        ("-mesh", mesh, "one card"),
        ("-mesh -mesh-rowshard", mesh + ["-mesh-rowshard"], "one card"),
        ("one card -fuse-s3", ["-fuse-s3"], None),
        ("-mesh -mesh-locality",
         mesh + ["-mesh-locality", "-mesh-rowshard", "-fuse-s3"],
         "one card -fuse-s3")]
    start, results, refs = None, {}, {}
    for name, flags, single in layouts:
        eng, _ = build_engine(link_sampling_argv(
            n, k, name.replace(" ", ""), *flags), network=net)
        if start is None:
            g0, l0 = host_state(eng)
            start = (g0, l0, 0.5 * g0 / g0.sum(1, keepdims=True))
        fused = bool(eng.cfg.fuse_s3)
        set_state(eng, start[0], start[1], start[2] if fused else None)
        if single is not None:
            print_layout(eng, name, cards)
        engine_sweep(eng, ph)
        results[name] = host_state(eng)
        del eng
        gc.collect()
        if fused not in refs:
            with ph.window("reference (device)"):
                refs[fused] = reference_for(
                    net, start[0], start[1],
                    mphi_prev=start[2] if fused else None, chunk=chunk)
                jax.block_until_ready(refs[fused])
        report_errors(f"{name} vs reference",
                      sweep_errors(*results[name], refs[fused]))
        if single is not None:
            want = refs[fused]._replace(gamma=results[single][0],
                                        lam=results[single][1])
            report_errors(f"{name} vs {single}",
                          sweep_errors(*results[name], want))
    del results, refs
    ph.done()

    ph = Phase(f"{cards} cards: the phase-1 CLI run with -mesh {cards} "
               f"against one card")
    work = enter_work("four-p1")
    edges, cover = make_phase1_graph(p1_n, p1_k, os.path.join(work, "gen"))
    argv = phase1_argv(edges, cover, p1_n, p1_k, max_iters)
    runs = {"one card": run_cli(argv + ["-label", "one"], ph,
                                "cli run, one card"),
            "-mesh": run_cli(argv + ["-label", "mesh"] + mesh, ph,
                             "cli run, -mesh")}
    for label, r in runs.items():
        print(f"  {label}: stopped at iteration {r['last_iter']}, best "
              f"nshol {r['best_nshol']:.5f}, NMI {r['nmi']:.4f}, median "
              f"{r['median_iter_s']:.6f} s per iteration [{smi}]")
    one, m = runs["one card"], runs["-mesh"]
    report_errors(f"-mesh {cards} CLI run vs one card", {
        "|d NMI|": (abs(m["nmi"] - one["nmi"]), MESH_NMI_TOL),
        "|d best nshol| / |nshol|": (
            abs(m["best_nshol"] - one["best_nshol"])
            / abs(one["best_nshol"]), MESH_NSHOL_RTOL)})
    ph.done()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="On-device smoke test of the link-sampling path.")
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-card layouts, on four GPUs")
    args = ap.parse_args(argv)
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        # phase 1 runs its reference on the host CPU device
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax
    cards = 4 if args.four else 1
    devs = require_gpu(cards)
    from svinet_tpu.cli import configure_compile_cache
    cache_dir = configure_compile_cache()
    _track_compiles()

    t0 = time.perf_counter()
    subprocess.run(["make", "-B", "-s", "-C", os.path.join(REPO, "native")],
                   check=True, timeout=300)
    print(f"native library rebuilt from native/ in "
          f"{time.perf_counter() - t0:.2f} s (host set-up)")
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    phase0(devs, cache_dir)
    if args.four:
        four(smi, cards=cards)
    else:
        phase1()
        phase2(smi)
    print(f"card: {smi}")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
