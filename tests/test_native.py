"""Cross-check the native C++ table toolchain against the Python rate
functions (the reference validated its table via generate_table.cpp's
printout; here the check is automated)."""

import numpy as np
import pytest

from fib_tf_tpu.models.courtemanche import (
    INTER_KEYS,
    calc_intermediates_np,
)
from fib_tf_tpu.ops import table as table_ops
from fib_tf_tpu.utils import native

@pytest.fixture(autouse=True, scope="module")
def _toolchain():
    """Build the binaries from the committed sources (native.build), or
    skip where no C++ compiler is present."""
    if not native.native_available():
        pytest.skip("native toolchain not buildable")


class TestNativeTable:
    def test_geometry(self):
        tbl = native.native_table()
        assert tbl.shape == (150, 30)
        assert np.isfinite(tbl).all()

    def test_matches_python_rates(self):
        tbl_native = native.native_table()
        tbl_py = table_ops.build_table(calc_intermediates_np, INTER_KEYS)
        # the Python path uses the V+10.0001 warning-suppression shift in
        # tau_d (court.py:302-307), the native path plain V+10 like the
        # CUDA original — hence 1e-4 rather than 1e-6
        np.testing.assert_allclose(tbl_native, tbl_py, rtol=1e-4, atol=1e-7)

    def test_golden_values_at_minus_50(self):
        """Spot values at V = -50 (the voltage the reference's
        generate_table driver printed, generate_table.cpp:14-23)."""
        inter_native = native.native_intermediates(-50.0)
        inter_py = calc_intermediates_np(np.asarray(-50.0))
        for i, k in enumerate(INTER_KEYS):
            np.testing.assert_allclose(
                inter_native[i], float(inter_py[k]), rtol=1e-4,
                err_msg=k,
            )

    def test_cell_sim_matches_python_0d(self):
        """The native 0D integrator must reproduce the JAX Courtemanche
        action potential (same multi-rate schedule) — the cross-language
        ground-truth check for the full right-hand side."""
        import subprocess

        import jax
        import jax.numpy as jnp

        from fib_tf_tpu.config import SimConfig
        from fib_tf_tpu.models import Courtemanche, cell_geometry

        exe = native.executable("cell_sim")
        out = subprocess.run(
            [exe, "300", "0.1", "20"], capture_output=True, text=True,
            check=True,
        ).stdout
        rows = np.asarray([
            [float(x) for x in line.split()]
            for line in out.strip().splitlines()
        ])
        v_native = rows[:, 1]

        cfg = SimConfig(width=8, height=8, dt=0.1, duration=1)
        model = Courtemanche(cfg)
        state = model.initial_state(s1=False)
        state["V"][:] = 20.0
        geom = cell_geometry()
        s = {k: jnp.asarray(v) for k, v in state.items()}

        def body(st, _):
            # single-rate group of 10 substeps = the cell_sim default
            for _i in range(10):
                st = model.solve(st, geom)
            return st, st["V"][0, 0]

        # match cell_sim's single-rate mode by overriding dt_for
        model.fast_states = tuple(state.keys())
        _, v_py = jax.jit(
            lambda st: jax.lax.scan(body, st, None, length=300)
        )(s)
        v_py = np.asarray(v_py)

        # f64 C++ vs f32 JAX drift over 300 ms: a few tenths of a mV
        assert np.abs(v_native - v_py).max() < 1.0
        assert abs(v_native[-1] - v_py[-1]) < 0.5

    def test_cell_sim_fenton_matches_python(self):
        import subprocess

        import jax
        import jax.numpy as jnp

        from fib_tf_tpu.config import SimConfig
        from fib_tf_tpu.models import Fenton4v, cell_geometry

        exe = native.executable("cell_sim_fb")
        out = subprocess.run(
            [exe, "fenton", "300", "0.1", "0.3"],
            capture_output=True, text=True, check=True,
        ).stdout
        u_native = np.asarray(
            [float(l.split()[1]) for l in out.strip().splitlines()]
        )

        model = Fenton4v(SimConfig(width=8, height=8, dt=0.1, duration=1))
        state = model.initial_state(s1=False)
        state["u"][:] = 0.3
        geom = cell_geometry()
        s = {k: jnp.asarray(v) for k, v in state.items()}

        def body(st, _):
            st = model.step(st, geom)
            return st, st["u"][0, 0]

        _, u_py = jax.jit(
            lambda st: jax.lax.scan(body, st, None, length=300)
        )(s)
        assert np.abs(u_native - np.asarray(u_py)).max() < 5e-3

    def test_cell_sim_br_matches_python(self):
        import subprocess

        import jax
        import jax.numpy as jnp

        from fib_tf_tpu.config import SimConfig
        from fib_tf_tpu.models import BeelerReuter, cell_geometry

        exe = native.executable("cell_sim_fb")
        out = subprocess.run(
            [exe, "br", "300", "0.1", "-30"],
            capture_output=True, text=True, check=True,
        ).stdout
        v_native = np.asarray(
            [float(l.split()[1]) for l in out.strip().splitlines()]
        )

        # compare against the DIRECT-rate Python path (the native sim has
        # no Chebyshev)
        model = BeelerReuter(SimConfig(
            width=8, height=8, dt=0.1, duration=1,
            cheby=False, fast_currents=False,
        ))
        state = model.initial_state(s1=False)
        state["V"][:] = -30.0
        geom = cell_geometry()
        s = {k: jnp.asarray(v) for k, v in state.items()}

        def body(st, _):
            st = model.step(st, geom)   # 5 substeps = 0.5 ms
            return st, st["V"][0, 0]

        _, v_py = jax.jit(
            lambda st: jax.lax.scan(body, st, None, length=600)
        )(s)
        v_py_ms = np.asarray(v_py)[1::2]   # sample every 1 ms
        # tight pin: the only remaining difference is f32 (JAX) vs f64
        # (C++); measured max delta 1.4e-4 mV.  A gate-ordering violation
        # (currents from post-update gates, the round-1 bug) shows up as
        # ~0.4 mV and MUST fail here.
        assert np.abs(v_native - v_py_ms).max() < 5e-3

    def test_cell_sim_br_skip_matches_python(self):
        """Same cross-check in multi-rate (--skip) mode, pinning the
        slow-gate freeze/advance schedule across Python and C++."""
        import subprocess

        import jax
        import jax.numpy as jnp

        from fib_tf_tpu.config import SimConfig
        from fib_tf_tpu.models import BeelerReuter, cell_geometry

        exe = native.executable("cell_sim_fb")
        out = subprocess.run(
            [exe, "br", "300", "0.1", "-30", "--skip"],
            capture_output=True, text=True, check=True,
        ).stdout
        v_native = np.asarray(
            [float(l.split()[1]) for l in out.strip().splitlines()]
        )

        model = BeelerReuter(SimConfig(
            width=8, height=8, dt=0.1, duration=1,
            cheby=False, skip=True, fast_currents=False,
        ))
        state = model.initial_state(s1=False)
        state["V"][:] = -30.0
        geom = cell_geometry()
        s = {k: jnp.asarray(v) for k, v in state.items()}

        def body(st, _):
            st = model.step(st, geom)   # 5 substeps = 0.5 ms
            return st, st["V"][0, 0]

        _, v_py = jax.jit(
            lambda st: jax.lax.scan(body, st, None, length=600)
        )(s)
        v_py_ms = np.asarray(v_py)[1::2]
        assert np.abs(v_native - v_py_ms).max() < 5e-3

    def test_cell_sim_lr1_matches_python(self):
        """Native Luo-Rudy 1991 (luo_rudy.h, written independently from
        the paper's rate table) vs the JAX model — cross-language
        validation for the stiff fifth family."""
        import subprocess

        import jax
        import jax.numpy as jnp

        from fib_tf_tpu.config import SimConfig
        from fib_tf_tpu.models import LuoRudy91, cell_geometry

        exe = native.executable("cell_sim_fb")
        out = subprocess.run(
            [exe, "lr1", "300", "0.02", "-50"],
            capture_output=True, text=True, check=True,
        ).stdout
        v_native = np.asarray(
            [float(l.split()[1]) for l in out.strip().splitlines()]
        )

        model = LuoRudy91(SimConfig(width=8, height=8, dt=0.02, duration=1))
        state = model.initial_state(s1=False)
        state["V"][:] = -50.0
        geom = cell_geometry()
        s = {k: jnp.asarray(v) for k, v in state.items()}

        def body(st, _):
            st = model.step(st, geom)   # 10 substeps = 0.2 ms
            return st, st["V"][0, 0]

        _, v_py = jax.jit(
            lambda st: jax.lax.scan(body, st, None, length=1500)
        )(s)
        v_py_ms = np.asarray(v_py)[4::5]   # sample every 1 ms
        # f32 (JAX) vs f64 (C++) through a ~400 V/s upstroke: the steep
        # dV/dt amplifies rounding differences right at the stimulus, so
        # the pin is looser than BR's smooth-path 5e-3 but still far
        # below any model-equation error (a wrong rate shifts the plateau
        # by whole mV for hundreds of ms)
        assert np.abs(v_native - v_py_ms).max() < 0.15
        assert np.abs(v_native - v_py_ms)[10:].max() < 5e-2

    def test_lookup_consumes_native_table(self):
        import jax.numpy as jnp

        tbl = jnp.asarray(native.native_table())
        v = jnp.asarray([[-81.2, 0.0], [20.0, -100.0]])
        out = table_ops.lookup(tbl, v, INTER_KEYS)
        assert out["m_inf"].shape == (2, 2)
        assert np.isfinite(np.asarray(out["tau_h"])).all()

    def test_cell_sim_tp06_matches_python(self):
        """Native TP06 (tp06.h, written independently from the paper's
        appendix) vs the JAX model — cross-language validation for the
        sixth family, covering the SR-calcium subsystem and the Ca-gated
        fCass gate that no other native model exercises."""
        import subprocess

        import jax
        import jax.numpy as jnp

        from fib_tf_tpu.config import SimConfig
        from fib_tf_tpu.models import TenTusscher06, cell_geometry

        exe = native.executable("cell_sim_fb")
        out = subprocess.run(
            [exe, "tp06", "400", "0.02", "-60"],
            capture_output=True, text=True, check=True,
        ).stdout
        rows = [l.split() for l in out.strip().splitlines()]
        v_native = np.asarray([float(r[1]) for r in rows])
        ca_native = np.asarray([float(r[2]) for r in rows])

        model = TenTusscher06(
            SimConfig(width=8, height=8, dt=0.02, duration=1))
        state = model.initial_state(s1=False)
        state["V"][:] = -60.0
        geom = cell_geometry()
        s = {k: jnp.asarray(v) for k, v in state.items()}

        def body(st, _):
            st = model.step(st, geom)   # 10 substeps = 0.2 ms
            return st, (st["V"][0, 0], st["Cai"][0, 0])

        _, (v_py, ca_py) = jax.jit(
            lambda st: jax.lax.scan(body, st, None, length=2000)
        )(s)
        v_py_ms = np.asarray(v_py)[4::5]     # sample every 1 ms
        ca_py_ms = np.asarray(ca_py)[4::5]
        # f32 (JAX) vs f64 (C++) through a ~370 V/s upstroke: same
        # budget shape as lr1's — loose at the stimulus, tight after
        assert np.abs(v_native - v_py_ms).max() < 0.2
        assert np.abs(v_native - v_py_ms)[10:].max() < 5e-2
        # the calcium subsystem is the new native coverage: pin Cai to
        # 1% of its dynamic range over the whole beat
        ca_rng = ca_native.max() - ca_native.min()
        assert np.abs(ca_native - ca_py_ms).max() < 0.01 * ca_rng
