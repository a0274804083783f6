"""Multi-host execution tests: 2 jax.distributed processes x 4 virtual
CPU devices each = an 8-device global mesh, coordinated over localhost.

The reference has no distributed backend (its pthread reduce,
src/mmsbinfer.cc:1770-1827, is single-address-space); here the same
sufficient-statistic reduce is a psum across every process's devices.
These tests prove the wiring end-to-end on one host: the sharded sweep on the 2-process global mesh must match the
single-process 8-device result, and the CLI -dist-* path must run a full
inference with every process executing the identical SPMD loop.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.distributed.initialize(f"localhost:{port}", num_processes=2,
                           process_id=pid)
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, %(repo)r)
from __graft_entry__ import _tiny_problem
from svinet_tpu.parallel.mesh import (
    make_mesh, shard_edges, make_sharded_multi_sweep,
    device_put_sharded_edges, device_put_replicated)
from svinet_tpu.svi.sweep_math import LSConsts

assert jax.process_count() == 2 and jax.device_count() == 8
n, k, block = 64, 4, 16
gamma, lam, edges, deg = _tiny_problem(n, k, n_edges=128)
mesh = make_mesh(8)
es, ms = shard_edges(edges, 8, block)
per_shard = es.shape[0] // 8
sweep = make_sharded_multi_sweep(mesh, per_shard // block)
e_d, m_d = device_put_sharded_edges(mesh, es, ms)
g_d, l_d, d_d = device_put_replicated(mesh, gamma, lam, jnp.asarray(deg))
consts = LSConsts(*device_put_replicated(
    mesh, jnp.float32(1.0 / k), jnp.asarray([1.0, 1.0], jnp.float32),
    jnp.float32(len(edges)), jnp.float32(n)))
ann, = device_put_replicated(mesh, jnp.float32(1.0))
g2, l2 = sweep(g_d, l_d, e_d, m_d, d_d, consts, ann, 3)
g2h, l2h = np.asarray(g2), np.asarray(l2)
if pid == 0:
    np.savez(out, gamma=g2h, lam=l2h)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _subproc_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_pair(cmds, cwd, timeout=420):
    procs = [subprocess.Popen(c, env=_subproc_env(), cwd=cwd,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    return outs


def test_two_process_sharded_sweep_matches_single(tmp_path):
    """The fused sharded sweep on a 2-process global mesh equals the
    single-process 8-device mesh result (same shards, same psum math)."""
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER % {"repo": REPO})
    out = tmp_path / "dist_result.npz"
    _run_pair([[sys.executable, str(script), str(pid), str(port), str(out)]
               for pid in (0, 1)], cwd=tmp_path)
    assert out.exists()
    got = np.load(out)

    # single-process expected result (in-process 8-device CPU mesh)
    import jax.numpy as jnp
    from __graft_entry__ import _tiny_problem
    from svinet_tpu.parallel.mesh import (
        make_mesh, shard_edges, make_sharded_multi_sweep,
        device_put_sharded_edges, device_put_replicated)
    from svinet_tpu.svi.sweep_math import LSConsts

    n, k, block = 64, 4, 16
    gamma, lam, edges, deg = _tiny_problem(n, k, n_edges=128)
    mesh = make_mesh(8)
    es, ms = shard_edges(edges, 8, block)
    sweep = make_sharded_multi_sweep(mesh, es.shape[0] // 8 // block)
    e_d, m_d = device_put_sharded_edges(mesh, es, ms)
    g_d, l_d, d_d = device_put_replicated(mesh, gamma, lam,
                                          jnp.asarray(deg))
    consts = LSConsts(*device_put_replicated(
        mesh, jnp.float32(1.0 / k), jnp.asarray([1.0, 1.0], jnp.float32),
        jnp.float32(len(edges)), jnp.float32(n)))
    ann, = device_put_replicated(mesh, jnp.float32(1.0))
    g_ref, l_ref = sweep(g_d, l_d, e_d, m_d, d_d, consts, ann, 3)
    np.testing.assert_allclose(got["gamma"], np.asarray(g_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["lam"], np.asarray(l_ref),
                               rtol=1e-4, atol=1e-3)


def test_cli_two_process_linksampling(tmp_path, assort_path):
    """Full CLI inference across 2 processes (-mesh 8 -dist-*): process 0
    writes the canonical outdir, process 1 a proc1/ subdir; the final
    gamma matches a single-process -mesh 8 run with the same seed."""
    port = _free_port()
    base = ["-file", assort_path, "-n", "75", "-k", "4", "-link-sampling",
            "-seed", "1", "-max-iterations", "10", "-no-stop",
            "-rfreq", "5", "-mesh", "8"]
    cmds = [[sys.executable, "-m", "svinet_tpu", *base, "-label", "dist",
             "-dist-coordinator", f"localhost:{port}",
             "-dist-nprocs", "2", "-dist-procid", str(pid)]
            for pid in (0, 1)]
    _run_pair(cmds, cwd=tmp_path)

    rundir = tmp_path / "n75-k4-dist-seed1-linksampling"
    assert (rundir / "gamma.txt").exists()
    assert (rundir / "proc1").exists()        # process 1 ran the SPMD loop
    rows = [l.split("\t") for l in open(rundir / "gamma.txt")]
    assert len(rows) == 75
    g_dist = np.array([r[2:] for r in rows], float)

    # single-process run, same flags (8 local devices, conftest mesh)
    from svinet_tpu.cli import main
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main([*base, "-label", "single"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    srun = tmp_path / "n75-k4-single-seed1-linksampling"
    g_single = np.array(
        [l.split("\t")[2:] for l in open(srun / "gamma.txt")], float)
    np.testing.assert_allclose(g_dist, g_single, rtol=2e-2, atol=1e-3)


def _write_n64_graph(path):
    """Deterministic n=64 graph (n % 8 == 0, every node covered): a ring
    plus planted 4-block random edges."""
    rng = np.random.default_rng(42)
    edges = {(i, (i + 1) % 64) for i in range(64)}
    for _ in range(400):
        b = rng.integers(0, 4)
        u, v = rng.integers(b * 16, (b + 1) * 16, 2)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    with open(path, "w") as f:
        for u, v in sorted(edges):
            f.write(f"{u}\t{v}\n")


@pytest.mark.parametrize("extra", [[], ["-fuse-s3"]],
                         ids=["plain", "fuse-s3"])
def test_cli_two_process_rowshard_matches_single(tmp_path, extra):
    """ROW-SHARDED gamma across 2 processes (-mesh 8 -mesh-rowshard
    -dist-*): the multi-host x model-sharding composition (round-2
    VERDICT #4). The final gamma must match a single-process
    -mesh 8 -mesh-rowshard run with the same seed. Parametrized over
    -fuse-s3 (the packed-row fused sweep must hold the same equality)."""
    graph = tmp_path / "n64.txt"
    _write_n64_graph(graph)
    port = _free_port()
    base = ["-file", str(graph), "-n", "64", "-k", "4", "-link-sampling",
            "-seed", "1", "-max-iterations", "10", "-no-stop",
            "-rfreq", "5", "-mesh", "8", "-mesh-rowshard", *extra]
    cmds = [[sys.executable, "-m", "svinet_tpu", *base, "-label", "rsd",
             "-dist-coordinator", f"localhost:{port}",
             "-dist-nprocs", "2", "-dist-procid", str(pid)]
            for pid in (0, 1)]
    _run_pair(cmds, cwd=tmp_path)

    rundir = tmp_path / "n64-k4-rsd-seed1-linksampling"
    assert (rundir / "gamma.txt").exists()
    g_dist = np.array([l.split("\t")[2:]
                       for l in open(rundir / "gamma.txt")], float)

    from svinet_tpu.cli import main
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main([*base, "-label", "rss"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    srun = tmp_path / "n64-k4-rss-seed1-linksampling"
    g_single = np.array([l.split("\t")[2:]
                         for l in open(srun / "gamma.txt")], float)
    np.testing.assert_allclose(g_dist, g_single, rtol=2e-2, atol=1e-3)


def test_cli_two_process_resume(tmp_path):
    """Multi-host -resume (round-2 VERDICT #5): every process restores
    the canonical (proc-0) checkpoint at the SAME iteration. A 6-iter
    run + resume-to-12 must match an uninterrupted 12-iter run, on the
    row-sharded 2-process mesh."""
    graph = tmp_path / "n64.txt"
    _write_n64_graph(graph)
    base = ["-file", str(graph), "-n", "64", "-k", "4", "-link-sampling",
            "-seed", "1", "-no-stop", "-rfreq", "5", "-mesh", "8",
            "-mesh-rowshard", "-checkpoint-freq", "100000"]

    def run_dist(label, extra):
        port = _free_port()
        cmds = [[sys.executable, "-m", "svinet_tpu", *base, *extra,
                 "-label", label,
                 "-dist-coordinator", f"localhost:{port}",
                 "-dist-nprocs", "2", "-dist-procid", str(pid)]
                for pid in (0, 1)]
        _run_pair(cmds, cwd=tmp_path)

    run_dist("full", ["-max-iterations", "12"])
    run_dist("part", ["-max-iterations", "6"])
    # the interrupted run saved its checkpoint in do_on_stop; resume it
    rundir = tmp_path / "n64-k4-part-seed1-linksampling"
    assert (rundir / "ckpt").exists(), "no checkpoint written at stop"
    assert not (rundir / "proc1" / "ckpt").exists(), \
        "proc 1 wrote its own checkpoint — canonical-dir fix regressed"
    run_dist("part", ["-max-iterations", "12", "-resume"])

    g_full = np.array([l.split("\t")[2:] for l in open(
        tmp_path / "n64-k4-full-seed1-linksampling" / "gamma.txt")], float)
    g_part = np.array([l.split("\t")[2:]
                       for l in open(rundir / "gamma.txt")], float)
    np.testing.assert_allclose(g_part, g_full, rtol=2e-2, atol=1e-3)
    # and the resumed run logged its restored iteration
    log = open(rundir / "infer.log").read()
    assert "stopped at iteration 13" in log


def test_cli_two_process_locality_matches_single(tmp_path):
    """-mesh-locality across 2 processes (round 5): the locality
    permutation is deterministic per graph, so every process derives the
    same layout; the boundary-rows-only collectives plus the
    report-batch trace must match the single-process locality run."""
    graph = tmp_path / "n64.txt"
    _write_n64_graph(graph)
    port = _free_port()
    base = ["-file", str(graph), "-n", "64", "-k", "4", "-link-sampling",
            "-seed", "1", "-max-iterations", "10", "-no-stop",
            "-rfreq", "1", "-report-batch", "5", "-mesh", "8",
            "-mesh-locality"]
    cmds = [[sys.executable, "-m", "svinet_tpu", *base, "-label", "locd",
             "-dist-coordinator", f"localhost:{port}",
             "-dist-nprocs", "2", "-dist-procid", str(pid)]
            for pid in (0, 1)]
    _run_pair(cmds, cwd=tmp_path)

    rundir = tmp_path / "n64-k4-locd-seed1-linksampling"
    assert (rundir / "gamma.txt").exists()
    g_dist = np.array([l.split("\t")[2:]
                       for l in open(rundir / "gamma.txt")], float)

    from svinet_tpu.cli import main
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main([*base, "-label", "locs"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    srun = tmp_path / "n64-k4-locs-seed1-linksampling"
    g_single = np.array([l.split("\t")[2:]
                         for l in open(srun / "gamma.txt")], float)
    np.testing.assert_allclose(g_dist, g_single, rtol=2e-2, atol=1e-3)
    # the two runs share the deterministic locality permutation, so the
    # heldout traces must line up row-for-row too
    h_d = np.array([l.split()[2:] for l in open(rundir / "heldout.txt")],
                   float)
    h_s = np.array([l.split()[2:] for l in open(srun / "heldout.txt")],
                   float)
    assert h_d.shape == h_s.shape
    np.testing.assert_allclose(h_d, h_s, rtol=2e-3, atol=2e-3)
