"""Platform plumbing: the persistent compile cache, the float32
precision pins, the absence of accelerator-specific code paths, the
GPU smoke script's helpers, and (on a card only) GPU == CPU."""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fib_tf_tpu.ops import stencil, stencil3d
from fib_tf_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCache:
    @pytest.fixture
    def fresh(self, monkeypatch):
        """cache.enable() from scratch; the process's cache directory is
        restored afterwards (nothing compiles in between)."""
        monkeypatch.setattr(cache, "_enabled", False)
        monkeypatch.delenv("FIB_NO_COMPILE_CACHE", raising=False)
        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_honours_jax_compilation_cache_dir(self, fresh, monkeypatch,
                                               tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        assert cache.cache_dir() is None
        cache.enable()
        # JAX keeps the directory it read from the environment
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)

    def test_defaults_to_the_checkout(self, fresh, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.cache_dir() == os.path.join(ROOT, ".jax_cache")
        cache.enable()
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR

    def test_opt_out(self, fresh, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setenv("FIB_NO_COMPILE_CACHE", "1")
        before = jax.config.jax_compilation_cache_dir
        cache.enable()
        assert jax.config.jax_compilation_cache_dir == before


class TestPrecision:
    """float32 contractions carry Precision.HIGHEST: a GPU may otherwise
    run them in TF32 (about three decimal digits)."""

    def test_conv_laplacian(self):
        x = jnp.ones((8, 8), jnp.float32)
        jaxpr = str(jax.make_jaxpr(stencil.laplace_conv)(x))
        assert "conv_general_dilated" in jaxpr
        assert "HIGHEST" in jaxpr

    def test_ecg_contraction(self):
        lap = jnp.ones((3, 4, 5), jnp.float32)
        w = jnp.ones((2, 3, 4, 5), jnp.float32)
        jaxpr = str(jax.make_jaxpr(stencil3d.ecg_sample)(lap, w))
        assert "dot_general" in jaxpr
        assert "HIGHEST" in jaxpr

    def test_ecg_sample_matches_numpy(self):
        rng = np.random.default_rng(0)
        lap = rng.standard_normal((3, 4, 5)).astype(np.float32)
        w = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
        got = np.asarray(stencil3d.ecg_sample(jnp.asarray(lap),
                                              jnp.asarray(w)))
        want = np.einsum("dhw,edhw->e", lap.astype(np.float64),
                         w.astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# What an accelerator-specific path looks like: a TPU Pallas import, a
# branch on the TPU backend, or a Pallas interpreter switch.
_FORBIDDEN = re.compile(
    r'pallas\.tpu|pltpu|default_backend\(\) *[!=]= *"tpu"|interpret=')


@pytest.mark.parametrize("where", [
    "fib_tf_tpu", "tools", "examples", "bench.py", "__graft_entry__.py",
    "chip_smoke.py",
])
def test_no_accelerator_specific_code(where):
    path = os.path.join(ROOT, where)
    files = ([path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path)
        for f in fs if f.endswith((".py", ".sh"))])
    assert files
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(open(f, encoding="utf-8"), 1)
            if _FORBIDDEN.search(line)]
    assert not hits, hits


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestChipSmokeHelpers:
    def test_device_guard_refuses_the_cpu(self):
        cs = _load_chip_smoke()
        with pytest.raises(RuntimeError, match="GPU"):
            cs.require_gpu(jax.devices())

    def test_device_guard_counts_cards(self):
        cs = _load_chip_smoke()

        class Dev:
            platform = "gpu"

        devs = [Dev(), Dev()]
        assert cs.require_gpu(devs, 1) == devs[:1]
        with pytest.raises(RuntimeError, match="4 GPU"):
            cs.require_gpu([Dev(), Dev()], 4)

    def test_option_parsing(self):
        cs = _load_chip_smoke()
        assert cs.parse_args([]).four_cards is False
        assert cs.parse_args(["--four-cards"]).four_cards is True
        with pytest.raises(SystemExit):
            cs.parse_args(["--cards", "4"])

    def test_result_line_format(self):
        cs = _load_chip_smoke()

        class Dev:
            platform = "gpu"
            device_kind = "NVIDIA H100 80GB HBM3"

        line = cs.result_line([Dev()] * 4)
        assert line == ('{"ok": true, "device": {"platform": "gpu", '
                        '"kind": "NVIDIA H100 80GB HBM3", "count": 4}}')
        assert json.loads(line)["device"]["count"] == 4

    def test_exits_nonzero_without_a_gpu(self, tmp_path):
        """Run as the driver runs it, on a host with no card: non-zero
        exit and no result line."""
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.fixture
def gpu():
    """The first GPU, or skip: decided here, never at import."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: run `python -m pytest -m gpu tests/` on a card")


@pytest.mark.gpu
def test_gpu_simulate_matches_cpu(gpu):
    """The same 64x64 BR run on the card and on the host CPU."""
    from fib_tf_tpu.config import SimConfig
    from fib_tf_tpu.engine import Simulation
    from fib_tf_tpu.models import BeelerReuter

    cfg = SimConfig(width=64, height=64, dt=0.1, diff=0.809, duration=20,
                    cheby=True, skip=True)
    out = {}
    for dev in (gpu, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            out[dev.platform] = Simulation(
                BeelerReuter(cfg)).define().simulate().state["V"]
    np.testing.assert_allclose(out["gpu"], out["cpu"], atol=0.1)
