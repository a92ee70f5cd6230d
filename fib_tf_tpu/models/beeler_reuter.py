"""The modified 8-variable Beeler-Reuter ventricular model.

Beeler GW, Reuter H. "Reconstruction of the action potential of ventricular
myocardial fibres." J Physiol. 1977;268:177-210.

Parity target: reference br.py:31-343.  Eight planes: V (diffusing), Ca
concentration C, and six Hodgkin-Huxley gates (m, h, j, d, f, x1) integrated
with Rush-Larsen.  Five substeps fuse into one outer step (br.py:96-107).

Compile-time variants (the reference's Table-1 2x2 benchmark matrix):
  * `cheby`: gate inf/tau curves replaced by degree-8 Chebyshev fits baked
    in at model-construction time (br.py:207-252) — no transcendentals in
    the gate path;
  * `skip` (multi-rate): slow gates (x1, j, d, f) advance once per outer
    step with dt*5 while fast m/h advance every substep (br.py:98-103).

Quirks preserved: the d- and f-gate rate prefactors are doubled to halve
the Ca activation/deactivation time constants so spirals are inducible
(br.py:46-61); V is clipped to [-85, 25] every substep (br.py:167-168);
S1 sets column 1 to +10 mV absolute (br.py:81-82).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models.base import Geometry, IonicModel, State
from fib_tf_tpu.ops.chebyshev import (
    chebyshev_eval,
    chebyshev_fit,
    chebyshev_terms,
    normalize_voltage,
)
from fib_tf_tpu.ops.integrators import rush_larsen

GATES = ("x1", "m", "h", "j", "d", "f")
FAST_GATES = ("m", "h")
SLOW_GATES = ("x1", "j", "d", "f")

# Rational-exponential rate parameterization (Beeler & Reuter 1977, Table 1):
#   rate(V) = (c0*exp(c1*(V+c2)) + c3*(V+c4)) / (exp(c5*(V+c2)) + c6)
# keyed by (gate, alpha|beta).  The d/f prefactors carry the x2 spiral
# modification noted in the module docstring.
RATE_PARAMS: Dict[Tuple[str, str], Tuple[float, ...]] = {
    ("x1", "a"): (0.0005, 0.083, 50.0, 0.0, 0.0, 0.057, 1.0),
    ("x1", "b"): (0.0013, -0.06, 20.0, 0.0, 0.0, -0.04, 1.0),
    ("m", "a"): (0.0, 0.0, 47.0, -1.0, 47.0, -0.1, -1.0),
    ("m", "b"): (40.0, -0.056, 72.0, 0.0, 0.0, 0.0, 0.0),
    ("h", "a"): (0.126, -0.25, 77.0, 0.0, 0.0, 0.0, 0.0),
    ("h", "b"): (1.7, 0.0, 22.5, 0.0, 0.0, -0.082, 1.0),
    ("j", "a"): (0.055, -0.25, 78.0, 0.0, 0.0, -0.2, 1.0),
    ("j", "b"): (0.3, 0.0, 32.0, 0.0, 0.0, -0.1, 1.0),
    ("d", "a"): (2 * 0.095, -0.01, -5.0, 0.0, 0.0, -0.072, 1.0),
    ("d", "b"): (2 * 0.07, -0.017, 44.0, 0.0, 0.0, 0.05, 1.0),
    ("f", "a"): (2 * 0.012, -0.008, 28.0, 0.0, 0.0, 0.15, 1.0),
    ("f", "b"): (2 * 0.0065, -0.02, 30.0, 0.0, 0.0, -0.2, 1.0),
}

CHEBY_DEG = 8
CHEBY_SAMPLES = 1001  # reference br.py:280

# Membrane constants (br.py:137-148)
G_S = 0.09
G_NA = 4.0
G_NAC = 0.005
E_NA = 50.0
C_M = 1.0
V_CLIP_LO = -85.0
V_CLIP_HI = 25.0


def rate_np(v: np.ndarray, c: Tuple[float, ...]) -> np.ndarray:
    """Numpy evaluation of the rate parameterization (definition time;
    reference br.py:275-287)."""
    v = np.asarray(v, dtype=np.float64)
    return (c[0] * np.exp(c[1] * (v + c[2])) + c[3] * (v + c[4])) / (
        np.exp(c[5] * (v + c[2])) + c[6]
    )


def rate_jnp(v: jnp.ndarray, c: Tuple[float, ...]) -> jnp.ndarray:
    """Traced evaluation for the direct (non-Chebyshev) path; skips the
    linear term when c3 == 0, like reference br.py:255-264."""
    if c[3] == 0:
        return (c[0] * jnp.exp(c[1] * (v + c[2]))) / (
            jnp.exp(c[5] * (v + c[2])) + c[6]
        )
    return (c[0] * jnp.exp(c[1] * (v + c[2])) + c[3] * (v + c[4])) / (
        jnp.exp(c[5] * (v + c[2])) + c[6]
    )


class BeelerReuter(IonicModel):
    name = "br"
    min_v = -90.0
    max_v = 30.0
    depol = -84.6
    dt_per_step = 5
    pot_key = "V"
    # intracellular calcium feeds log(c) in e_ca — the adaptive-dt
    # acceptance test keeps it strictly positive (ops/adaptive.py)
    positive_states = ("C",)
    # channel-block (drug) interface (models/base.set_scale /
    # SimConfig.g_scale): the four BR currents — g_Na/g_NaC the fast +
    # background Na, g_s the slow inward (Ca), g_K1/g_x1 the two K
    # currents (applied uniformly across the cheby/fast/plain variants)
    SCALE_PARAMS = ("g_Na", "g_NaC", "g_s", "g_K1", "g_x1")

    def __init__(self, cfg: SimConfig):
        super().__init__(cfg)
        if cfg.cheby:
            self._cheby_coef = self._fit_chebyshev()

    # -- definition-time Chebyshev fits ----------------------------------------

    def _fit_chebyshev(self) -> Dict[str, np.ndarray]:
        """Fit inf(V) and tau(V) of each gate on [min_v, max_v]
        (reference br.py:221-240, 275-287).

        With `cheby_fold`, additionally fit the full Rush-Larsen
        multiplier r(V) = expm1(-dt_g / tau(V)) for each dt actually used
        (dt for m/h; dt or 5*dt for the slow gates depending on `skip`) —
        dt is a compile-time constant, so the runtime gate update becomes
        a pure polynomial + FMA with no divide/exp."""
        v = np.linspace(self.min_v, self.max_v, CHEBY_SAMPLES)
        coef = {}
        slow_n = 5 if self.cfg.skip else 1
        self._fold_slow_n = slow_n
        for g in GATES:
            a = rate_np(v, RATE_PARAMS[(g, "a")])
            b = rate_np(v, RATE_PARAMS[(g, "b")])
            tau = 1.0 / (a + b)
            coef[f"{g}_inf"] = chebyshev_fit(v, a / (a + b), CHEBY_DEG)
            coef[f"{g}_tau"] = chebyshev_fit(v, tau, CHEBY_DEG)
            if self.cfg.cheby_fold:
                n = 1 if g in FAST_GATES else slow_n
                r = np.expm1(-(self.cfg.dt * n) / tau)
                coef[f"{g}_rl"] = chebyshev_fit(v, r, CHEBY_DEG)
        if self.cfg.cheby_currents:
            i_k1 = 0.35 * (
                4.0 * (np.exp(0.04 * (v + 85.0)) - 1.0)
                / (np.exp(0.08 * (v + 53.0)) + np.exp(0.04 * (v + 53.0)))
                + 0.2 * ((v + 23.0) / (1.0 - np.exp(-0.04 * (v + 23.0))))
            )
            i_x1f = (
                0.8 * (np.exp(0.04 * (v + 77.0)) - 1.0)
                / np.exp(0.04 * (v + 35.0))
            )
            coef["i_k1"] = chebyshev_fit(v, i_k1, CHEBY_DEG)
            coef["i_x1f"] = chebyshev_fit(v, i_x1f, CHEBY_DEG)
        return coef

    # -- state ------------------------------------------------------------------

    def state_keys(self):
        base = ("C", "V", "d", "f", "h", "j", "m", "x1")
        if self.cfg.ab2:
            return tuple(sorted(base + ("_dV_", "_dC_")))
        return base

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        """Resting state (br.py:71-78) with the S1 stripe (br.py:81-82)."""
        v = self._full(-84.624)
        if s1:
            v[:, 1] = 10.0
        st = {
            "V": v,
            "C": self._full(1e-4),
            "m": self._full(0.01),
            "h": self._full(0.988),
            "j": self._full(0.975),
            "d": self._full(0.003),
            "f": self._full(0.994),
            "x1": self._full(0.0001),
        }
        if self.cfg.ab2:
            st = self.bootstrap_ab2(st)
        return st

    def _ab2_rates(self, state):
        """Traced AB2 derivative-plane refresh (reaction only): pure jnp,
        usable inside jit — the engine's pacing op re-bootstraps through
        this after mutating V."""
        i_k1, i_x1, i_na, i_ca = self.currents(
            jnp.asarray(state["V"]), state["C"], state
        )
        return {
            "_dV_": -(i_k1 + i_x1 + i_na + i_ca) / C_M,
            "_dC_": -1.0e-7 * i_ca + 0.07 * (1.0e-7 - state["C"]),
        }

    def bootstrap_ab2(self, state: Dict[str, np.ndarray]):
        """(Re)build the AB2 derivative planes: f_{-1} := reaction
        derivative of `state` (exact in 0D; the diffusion term is zero
        away from sharp fronts).  Call after mutating a state by hand or
        when resuming an Euler-run state into an ab2 model."""
        st = dict(state)
        st.update({
            k: np.asarray(v, np.float32)
            for k, v in self._ab2_rates(st).items()
        })
        return st

    # -- gate updates -------------------------------------------------------------

    def _inf_tau_direct(self, v0, gate):
        a = rate_jnp(v0, RATE_PARAMS[(gate, "a")])
        b = rate_jnp(v0, RATE_PARAMS[(gate, "b")])
        return a / (a + b), 1.0 / (a + b)

    def _terms(self, v0):
        """The shared Chebyshev leading-term chain for this substep."""
        x = normalize_voltage(v0, self.min_v, self.max_v)
        return chebyshev_terms(x, CHEBY_DEG)

    def _update_gates(self, v0, state, n: int, terms=None):
        """Advance m/h by dt and (when n > 0) the slow gates by dt*n,
        via direct rates or Chebyshev fits (br.py:175-252)."""
        dt = self.cfg.dt
        out = {}
        if self.cfg.cheby:
            if terms is None:
                terms = self._terms(v0)

            if self.cfg.cheby_fold:
                # folded form: g' = clip(g + (g - g_inf) * r(V)) where
                # r(V) = expm1(-dt_g/tau(V)) was fit at definition time —
                # dt_g is BAKED IN (dt for fast gates, dt*slow_n for slow
                # ones), so the caller's n must match the baked cadence;
                # driving solve(n=1) per substep with skip+fold would
                # silently advance slow gates 5x (APD90 202 -> 71 ms)
                from fib_tf_tpu.ops.integrators import GATE_MAX, GATE_MIN

                def advance(gate, n_):
                    baked = 1 if gate in FAST_GATES else self._fold_slow_n
                    if n_ != baked:
                        raise ValueError(
                            f"cheby_fold baked dt*{baked} for gate "
                            f"{gate!r} but solve was driven with n={n_}; "
                            "with skip+fold, drive the model through "
                            "step() (or set cheby_fold=False)"
                        )
                    inf = chebyshev_eval(
                        self._cheby_coef[f"{gate}_inf"], terms)
                    r = chebyshev_eval(self._cheby_coef[f"{gate}_rl"], terms)
                    return jnp.clip(
                        state[gate] + (state[gate] - inf) * r,
                        GATE_MIN, GATE_MAX,
                    )
            else:
                def advance(gate, n_):
                    inf = chebyshev_eval(
                        self._cheby_coef[f"{gate}_inf"], terms)
                    tau = chebyshev_eval(
                        self._cheby_coef[f"{gate}_tau"], terms)
                    return rush_larsen(state[gate], inf, tau, dt * n_)
        else:
            def advance(gate, n_):
                inf, tau = self._inf_tau_direct(v0, gate)
                return rush_larsen(state[gate], inf, tau, dt * n_)

        for g in FAST_GATES:
            out[g] = advance(g, 1)
        if n > 0:
            for g in SLOW_GATES:
                out[g] = advance(g, n)
        else:
            for g in SLOW_GATES:
                out[g] = state[g]
        return out

    # -- dynamics ---------------------------------------------------------------

    def currents(self, v0, c, gates, terms=None):
        """The four membrane currents (br.py:150-165).

        Three compile-time variants for the V-only parts (iK1 and ix1's
        voltage factor):
          * `cheby_currents` (default, requires cheby): degree-8 fits
            sharing the gate fits' term chain — no transcendentals left;
          * `fast_currents`: one shared k = exp(0.04*V) instead of five
            exponentials — the optimization the reference sketched at
            br.py:153-158; algebraically identical;
          * plain: the literal reference forms.
        """
        if self.cfg.cheby and self.cfg.cheby_currents:
            if terms is None:
                terms = self._terms(v0)
            i_k1 = chebyshev_eval(self._cheby_coef["i_k1"], terms)
            i_x1 = gates["x1"] * chebyshev_eval(
                self._cheby_coef["i_x1f"], terms)
        elif self.cfg.fast_currents:
            k = jnp.exp(0.04 * v0)
            a85 = float(np.exp(0.04 * 85.0))
            a53b = float(np.exp(0.08 * 53.0))
            a53 = float(np.exp(0.04 * 53.0))
            a23 = float(np.exp(-0.04 * 23.0))
            a77 = float(np.exp(0.04 * 77.0))
            a35 = float(np.exp(0.04 * 35.0))
            i_k1 = 0.35 * (
                4.0 * (a85 * k - 1.0) / (a53b * k * k + a53 * k)
                + 0.2 * ((v0 + 23.0) / (1.0 - a23 / k))
            )
            i_x1 = gates["x1"] * 0.8 * (a77 * k - 1.0) / (a35 * k)
        else:
            i_k1 = 0.35 * (
                4.0 * (jnp.exp(0.04 * (v0 + 85.0)) - 1.0)
                / (jnp.exp(0.08 * (v0 + 53.0)) + jnp.exp(0.04 * (v0 + 53.0)))
                + 0.2 * ((v0 + 23.0) / (1.0 - jnp.exp(-0.04 * (v0 + 23.0))))
            )
            i_x1 = (
                gates["x1"] * 0.8 * (jnp.exp(0.04 * (v0 + 77.0)) - 1.0)
                / jnp.exp(0.04 * (v0 + 35.0))
            )
        # channel-block factors (models/base.set_scale) applied once after
        # the branch chain, so all three iK1/ix1 variants scale alike
        i_k1 = self.gscale("g_K1", i_k1)
        i_x1 = self.gscale("g_x1", i_x1)
        i_na = (
            self.gscale("g_Na", G_NA)
            * gates["m"] ** 3 * gates["h"] * gates["j"]
            + self.gscale("g_NaC", G_NAC)
        ) * (v0 - E_NA)
        e_ca = -82.3 - 13.0278 * jnp.log(c)
        i_ca = self.gscale("g_s", G_S) * gates["d"] * gates["f"] * (v0 - e_ca)
        return i_k1, i_x1, i_na, i_ca

    def solve(self, state: State, geom: Geometry, n: int = 1) -> State:
        """One substep; `n` is how many dt the slow gates advance
        (0 = frozen, the multi-rate trick; br.py:125-173)."""
        dt = self.cfg.dt
        v0 = geom.enforce_boundary(state["V"])
        terms = self._terms(v0) if self.cfg.cheby else None
        gates = self._update_gates(v0, state, n, terms)

        # Currents use the PRE-update gates: reference br.py:160-168 feeds
        # M/H/J/D/F/XI (not M1...) into iNa/iCa/ix1.  Ordering is
        # load-bearing (~0.4 mV/AP if violated).
        i_k1, i_x1, i_na, i_ca = self.currents(v0, state["C"], state, terms)
        i_sum = i_k1 + i_x1 + i_na + i_ca

        if not self.cfg.ab2:
            v1 = jnp.clip(
                v0 + self.cfg.diff * dt * geom.laplace(v0) - dt * i_sum / C_M,
                V_CLIP_LO,
                V_CLIP_HI,
            )
            c1 = state["C"] + dt * (
                -1.0e-7 * i_ca + 0.07 * (1.0e-7 - state["C"])
            )
            out = {"V": v1, "C": c1}
            out.update(gates)
            return out

        # opt-in Adams-Bashforth-2 on the Euler-updated planes (V, Ca);
        # the Rush-Larsen gates above are exponential integrators and
        # keep their form
        from fib_tf_tpu.ops.integrators import adams_bashforth2

        g_v = self.cfg.diff * geom.laplace(v0) - i_sum / C_M
        g_c = -1.0e-7 * i_ca + 0.07 * (1.0e-7 - state["C"])
        v1_raw = adams_bashforth2(v0, g_v, state["_dV_"], dt)
        v1 = jnp.clip(v1_raw, V_CLIP_LO, V_CLIP_HI)
        # where the clip engages, the carried history must describe the
        # clipped trajectory, not the unclipped one: store the effective
        # derivative (v1 - v0)/dt there (ADVICE r2; a no-op when the clip
        # does not fire, which is the steady state)
        g_v_store = jnp.where(v1 == v1_raw, g_v, (v1 - v0) / dt)
        out = {
            "V": v1,
            "C": adams_bashforth2(state["C"], g_c, state["_dC_"], dt),
            "_dV_": g_v_store,
            "_dC_": g_c,
        }
        out.update(gates)
        return out

    @property
    def has_uniform_substeps(self) -> bool:
        """Without `skip` the 5 substeps are identical solve(n=1) calls;
        the skip schedule (one n=5 + four n=0) is not splittable at
        arbitrary boundaries."""
        return not self.cfg.skip and self.cfg.adaptive_dv is None

    def step(self, state: State, geom: Geometry,
             unroll: bool = True) -> State:
        """One outer step = 5 substeps; with `skip`, the first substep
        advances the slow gates 5 dt and the rest freeze them
        (br.py:96-107).  `unroll=False` puts the identical substeps under
        lax.fori_loop (models/base.repeat_substeps)."""
        from fib_tf_tpu.models.base import repeat_substeps

        if self.cfg.adaptive_dv is not None:
            # step-doubling (SimConfig.adaptive_dv): each substep keeps
            # its skip-group `n` — a refined n=5 substep becomes two
            # half-dt n=5 solves, so the slow gates still advance
            # 2 x 5 x dt/2 = 5 dt and the clone's folded Chebyshev
            # multipliers (which bake 5 x dt/2) stay consistent
            def sub(n):
                return self.adaptive_substep(
                    geom, lambda m, s: m.solve(s, geom, n=n)
                )

            if self.cfg.skip:
                state = sub(5)(state)
                state = repeat_substeps(sub(0), state, 4, unroll)
            else:
                state = repeat_substeps(sub(1), state, 5, unroll)
            return state
        if self.cfg.skip:
            state = self.solve(state, geom, n=5)
            state = repeat_substeps(
                lambda s: self.solve(s, geom, n=0), state, 4, unroll
            )
        else:
            state = repeat_substeps(
                lambda s: self.solve(s, geom, n=1), state, 5, unroll
            )
        return state
