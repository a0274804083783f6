"""The engine's sweep programs against the plain float32 reference
(svinet_tpu/reference.py), on the virtual CPU mesh; plus the pieces of
the on-device smoke test (chip_smoke.py) that run without a GPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from svinet_tpu.ops.edges import pad_edges
from svinet_tpu.reference import check_sweep, reference_sweep
from svinet_tpu.svi import linksampling as ls

N, K = 420, 6


def _planted_edges(n=N, k=K, seed=3):
    from svinet_tpu.svi.gen import draw_planted
    _, _, edges = draw_planted(np.random.default_rng(seed),
                               jax.random.PRNGKey(seed), n, k, 3.0, 47.0,
                               True, 1e-30)
    return edges


def _engine(tmp_path, monkeypatch, *flags):
    monkeypatch.chdir(tmp_path)
    return chip_smoke.build_engine(
        chip_smoke.link_sampling_argv(N, K, "t", *flags),
        edges=_planted_edges())


@pytest.mark.parametrize("program", ["sweep", "multi_sweep_3",
                                     "multi_sweep_ho", "fused_multi_sweep"])
def test_engine_sweeps_match_reference(tmp_path, monkeypatch, program):
    """Every single-device sweep program, over several padded edge blocks,
    lands where the unblocked, unpadded reference does."""
    eng, net = _engine(tmp_path, monkeypatch)
    g0, l0 = chip_smoke.host_state(eng)
    edges, mask = pad_edges(net.training_links, 64)
    e, m = jnp.asarray(edges), jnp.asarray(mask)
    nb = edges.shape[0] // 64
    assert nb > 2
    ann = jnp.float32(1.0)
    g, lam = jnp.asarray(g0), jnp.asarray(l0)
    mphi0 = (0.5 * g0 / g0.sum(1, keepdims=True)).astype(np.float32)
    sweeps, mphi_prev = 1, None
    if program == "sweep":
        g, lam = ls.linksampling_sweep(g, lam, e, m, eng.deg, eng.consts,
                                       ann, nb)
    elif program == "multi_sweep_3":
        sweeps = 3
        g, lam = ls.linksampling_multi_sweep(g, lam, e, m, eng.deg,
                                             eng.consts, ann, nb, sweeps)
    elif program == "multi_sweep_ho":
        hp, hy, hw, hb = eng._ho_dev
        g, lam, sums = ls.linksampling_multi_sweep_ho(
            g, lam, e, m, eng.deg, eng.consts, ann, hp, hy, hw,
            jnp.float32(eng.cfg.epsilon), nb, 1, hb)
        assert np.all(np.isfinite(np.asarray(sums)))
    else:
        mphi_prev = mphi0
        g, lam, _ = ls.linksampling_fused_multi_sweep(
            g, lam, jnp.asarray(mphi0), e, m, eng.deg, eng.consts, ann, nb,
            1)
    rg, rl = g0, l0
    for _ in range(sweeps):
        ref = chip_smoke.reference_for(net, rg, rl, mphi_prev=mphi_prev)
        rg, rl = ref.gamma, ref.lam
    check_sweep(np.asarray(g), np.asarray(lam), ref, program)


@pytest.mark.parametrize("flags", [
    ("-mesh", "8"),
    ("-mesh", "8", "-mesh-rowshard"),
    ("-mesh", "8", "-mesh-locality"),
], ids=["replicated", "rowshard", "locality"])
def test_mesh_sweeps_match_reference(tmp_path, monkeypatch, flags):
    """One engine step of each -mesh layout on the 8-device mesh (n=420 is
    not a multiple of 8, so row-sharded layouts pad) against the
    reference; -mesh-locality fuses s3, which lags by one sweep."""
    eng, net = _engine(tmp_path, monkeypatch, *flags)
    assert eng.gamma.sharding.num_devices == 8
    g0, l0 = chip_smoke.host_state(eng)
    fused = bool(eng.cfg.fuse_s3)
    mphi0 = (0.5 * g0 / g0.sum(1, keepdims=True)) if fused else None
    chip_smoke.set_state(eng, g0, l0, mphi0)
    eng.step(1)
    ref = chip_smoke.reference_for(net, g0, l0, mphi_prev=mphi0)
    check_sweep(*chip_smoke.host_state(eng), ref, " ".join(flags))


def test_reference_chunks_agree():
    """Splitting the links into slices only bounds memory: the sweep is
    the same."""
    edges = _planted_edges(120, 4, seed=5)
    n = int(edges.max()) + 1
    deg = np.bincount(edges.ravel(), minlength=n).astype(np.float32)
    g0 = np.random.default_rng(0).gamma(2.0, 1.0, (n, 4)) + 0.25
    args = (g0, np.ones((4, 2)), edges, deg, 0.25, (1.0, 1.0),
            float(len(edges)), True)
    chunked = reference_sweep(*args, chunk=37)
    check_sweep(chunked.gamma, chunked.lam, reference_sweep(*args),
                "chunked")


@pytest.mark.parametrize("phase", ["phase1", "phase2", "four"])
def test_chip_smoke_phases_rehearse_on_cpu(tmp_path, monkeypatch, phase):
    """chip_smoke's phases at a small size on the CPU mesh: the control
    flow, the engine comparisons and the output checks of what runs on
    the card (four uses all 8 virtual devices as its cards)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    if phase == "phase1":
        run = chip_smoke.phase1(n=1500, k=8, nmi_floor=0.3)
        assert run["gamma_rows"] > 0 and run["last_iter"] < 400
    elif phase == "phase2":
        chip_smoke.phase2("cpu", n=1500, k=8, chunk=1000)
    else:
        chip_smoke.four("cpu", n=1500, k=8, p1_n=1500, p1_k=8, chunk=1000,
                        cards=8)


def test_chip_smoke_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


@pytest.mark.parametrize("env_set", [True, False],
                         ids=["env_set", "env_unset"])
def test_compile_cache_placement(tmp_path, monkeypatch, env_set):
    from svinet_tpu.cli import REPO_DIR, configure_compile_cache
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert configure_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = configure_compile_cache()
            assert path == os.path.join(REPO_DIR, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["single", "rowsharded"])
def test_checkpoint_roundtrip_without_orbax(tmp_path, monkeypatch, sharded):
    """The numpy checkpoint branch, the one that runs where orbax is not
    installed, restores arrays, scalars and the row sharding."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from svinet_tpu.io import checkpoint
    from svinet_tpu.parallel.mesh import make_mesh
    monkeypatch.setattr(checkpoint, "_HAVE_ORBAX", False)
    g = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    lam = np.ones((3, 2), np.float32)
    shardings = None
    if sharded:
        mesh = make_mesh(8)
        shardings = {"gamma": NamedSharding(mesh, P("edges"))}
    state = {"gamma": jnp.asarray(g), "lam": jnp.asarray(lam),
             "iteration": 7, "stopper": [0.5, -0.1]}
    checkpoint.save_checkpoint(str(tmp_path), state, 7)
    assert os.path.exists(tmp_path / "ckpt" / "7.npz")
    got = checkpoint.load_checkpoint(str(tmp_path), shardings=shardings)
    np.testing.assert_array_equal(np.asarray(got["gamma"]), g)
    np.testing.assert_array_equal(np.asarray(got["lam"]), lam)
    assert got["iteration"] == 7 and got["stopper"] == [0.5, -0.1]
    if sharded:
        assert got["gamma"].sharding == shardings["gamma"]


def test_native_library_rebuilt_when_stale(tmp_path, monkeypatch):
    """A library older than its sources is rebuilt, not loaded as is."""
    from svinet_tpu.io import native
    src = tmp_path / "native"
    src.mkdir()
    for name in ("ingest.cpp", "Makefile"):
        (src / name).write_text("")
    so = src / "libsvinet_native.so"
    monkeypatch.setattr(native, "_NATIVE_DIR", str(src))
    monkeypatch.setattr(native, "_SO_PATH", str(so))
    assert native._stale()
    so.write_text("")
    os.utime(so, (2e9, 2e9))
    assert not native._stale()
    os.utime(src / "Makefile", (2e9 + 1, 2e9 + 1))
    assert native._stale()
