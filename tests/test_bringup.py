"""Device bring-up contracts that hold without an accelerator: the compile
cache location, the peak table, the one precision policy of the sweep,
chip_smoke.py refusing to run off the GPU, and its kernel-comparison
helpers at tiny widths (CPU on both sides)."""
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# compile cache directory rule (utils/cache.py)
# ---------------------------------------------------------------------------
@pytest.fixture
def restore_cache_config():
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


@pytest.mark.parametrize("from_env", [True, False])
def test_compilation_cache_dir_rule(monkeypatch, tmp_path, from_env,
                                    restore_cache_config):
    from functionalmf_tpu.utils.cache import (
        default_cache_dir, enable_compilation_cache)
    before = jax.config.jax_compilation_cache_dir
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compilation_cache() == str(tmp_path)
        # jax reads the variable itself; code sets no directory
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = enable_compilation_cache()
        # one fixed path inside the checkout, the same on every call
        assert got == default_cache_dir() == enable_compilation_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert os.path.isdir(got)


# ---------------------------------------------------------------------------
# peak table (bench/peaks.py; bench.py shadows a `bench` package)
# ---------------------------------------------------------------------------
def _peaks_for(kind):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "peaks", os.path.join(REPO, "bench", "peaks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.peaks_for(kind)


def test_peaks_known_kind():
    p = _peaks_for("NVIDIA H100 80GB HBM3")
    assert p["f32_flops"] == 67e12
    assert p["tf32_flops"] == 495e12
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in p["source"]


def test_peaks_unknown_kind_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        _peaks_for("cpu")


# ---------------------------------------------------------------------------
# one precision policy: every dot the sweep traces is HIGHEST (float32)
# ---------------------------------------------------------------------------
def _small_model(kind, rng):
    import functionalmf_tpu as fmf
    n, m, T, k = 5, 4, 10, 2
    if kind == "gaussian":
        model = fmf.GaussianBayesianTensorFiltering(n, m, T, nembeds=k,
                                                    tf_order=2, seed=0)
        data = rng.normal(size=(n, m, T))
    elif kind == "binomial":
        model = fmf.BinomialBayesianTensorFiltering(n, m, T, nembeds=k,
                                                    tf_order=2, seed=0)
        N = np.full((n, m, T), 10.0)
        data = (rng.binomial(10, 0.4, size=(n, m, T)).astype(float), N)
    else:
        import chip_smoke as cs
        d = cs.gdelt_data(n, m, T, k)
        model = cs.production_model(n, m, T, k, 8, d["W0"], d["V0"])
        data = d["Y"]
    return model, data


@pytest.mark.parametrize("kind", ["gaussian", "binomial", "constrained"])
def test_sweep_dots_traced_at_float32(kind, rng):
    model, data = _small_model(kind, rng)
    keys = jax.random.PRNGKey(0)[None]
    text = jax.jit(model._batched_sweep()).lower(
        dict(model.state), model.prepare_data(data), keys).as_text()
    dots = [ln for ln in text.splitlines()
            if re.search(r"stablehlo\.dot(_general)?\b", ln)]
    assert dots, "the sweep traced no dot"
    bad = [ln.strip() for ln in dots
           if "precision = [HIGHEST, HIGHEST]" not in ln]
    assert not bad, bad[:3]


# ---------------------------------------------------------------------------
# chip_smoke.py: no GPU, no result line
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """Under JAX_PLATFORMS=cpu (and in a directory that holds the script
    and nothing else of the repo) it exits non-zero without "ok": true."""
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# ---------------------------------------------------------------------------
# chip_smoke.py kernel-comparison helpers at tiny widths, CPU vs CPU
# ---------------------------------------------------------------------------
def test_smoke_helper_banded():
    import chip_smoke as cs
    cpu = jax.devices("cpu")[0]
    r = cs.check_banded(cpu, cpu, batch=2, T=12, k=2, tf_order=2)
    assert r["dev"] == r["ref"]
    assert r["dev"]["solve"] < 1e-2 and r["dev"]["sample"] < 1e-3


def test_smoke_helper_dense():
    import chip_smoke as cs
    cpu = jax.devices("cpu")[0]
    r = cs.check_dense(cpu, cpu, batch=3, D=6)
    assert r["dev"] == r["ref"]
    assert r["dev"]["solve"] < 1e-4 and r["dev"]["sample"] < 1e-4


def test_smoke_helper_gass():
    import chip_smoke as cs
    cpu = jax.devices("cpu")[0]
    g = cs.check_gass(cpu, cpu, nrows=4, bs=3, k=2, ngrid=8)
    assert g["dev"]["grid"].shape == (8,)
    np.testing.assert_array_equal(g["dev"]["grid"], g["ref"]["grid"])
    assert g["dev"]["margin"] >= -1e-6


def test_smoke_helper_pg_gamma_moments():
    import chip_smoke as cs
    cpu = jax.devices("cpu")[0]
    rows = cs.check_pg_gamma(cpu, ndraws=20000, nexact=2000)
    assert len(rows) == 21
    bad = [r for r in rows if not abs(r[2] - r[3]) <= r[4]]
    assert not bad, bad


# ---------------------------------------------------------------------------
# on the card: the kernels phase, in a child process that owns the GPU
# ---------------------------------------------------------------------------
@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU answers nvidia-smi. Decided here, at run
    time: the parent pytest process stays on the CPU backend."""
    smi = shutil.which("nvidia-smi")
    ok = smi is not None and subprocess.run(
        [smi, "-L"], capture_output=True).returncode == 0
    if not ok:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi found none)")


@pytest.mark.gpu
def test_chip_smoke_kernels_phase_on_gpu(gpu):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phase",
                           "kernels"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1].startswith('{"ok": true')
