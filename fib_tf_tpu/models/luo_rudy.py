"""The Luo-Rudy 1991 (phase-1) guinea-pig ventricular model.

Luo CH, Rudy Y. "A model of the ventricular cardiac action potential.
Depolarization, repolarization, and their interaction." Circ Res.
1991;68:1501-1526.

A zoo extension beyond the reference (which ships Fenton 4v,
Beeler-Reuter, and Courtemanche — SURVEY.md §2 components 2-7; this
model has no reference counterpart).  Eight planes: V (diffusing),
intracellular calcium Cai, and six Hodgkin-Huxley gates (m, h, j, d, f,
x) integrated with the zoo's expm1+clip Rush-Larsen form
(ops/integrators.rush_larsen, reference ionic.py:115-123 parity form).

Why it's in the zoo:

  * it is the classic STIFF ventricular model — its fast sodium current
    (g_Na = 23 mS/cm², ~10x Beeler-Reuter's, max upstroke ~390 V/s)
    needs dt ≈ 0.02 ms under explicit Euler where the rest of the zoo
    runs at 0.1 ms.  That makes it the natural customer for the
    adaptive-dt step-doubling integrator (`SimConfig.adaptive_dv`),
    which refines only the handful of upstroke substeps instead of
    paying the small dt everywhere;
  * the h/j gates are genuinely piecewise (branch at V = -40 mV) and
    alpha_m / Xi / K1_inf carry removable singularities — exercising
    rate-evaluation machinery the smooth Beeler-Reuter rates never
    touch.

Model contract matches the rest of the zoo (models/base.py): pure
`solve`/`step` over injected Geometry, so 0D cell tests, 2D tissue
(phase fields, anisotropy), 3D volumes, ensembles, GSPMD/shard_map
sharding, and adaptive-dt all work unchanged.  Rates are evaluated
DIRECTLY (no Chebyshev variant): the piecewise h/j branches fit
poorly.

Constants: reversal potentials are computed from the paper's ionic
concentrations ([K]o=5.4, [K]i=145, [Na]o=140, [Na]i=18 mM) at T=310 K
(RT/F = 26.71 mV): E_Na = +54.8, E_K = -77.6 (with the Na/K permeability
ratio 0.01833), E_K1 = E_Kp = -87.9 mV.  E_si comes from the paper's
fitted form 7.7 - 13.0287 ln(Cai).
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models.base import Geometry, IonicModel, State
from fib_tf_tpu.ops.integrators import rush_larsen

GATES = ("m", "h", "j", "d", "f", "x")
# Multi-rate split for cfg.skip (the reference's flagship Beeler-Reuter
# technique, br.py:96-107, applied here): the Na-current gates m/h/j act
# on sub-millisecond scales during the upstroke and advance every 0.02 ms
# substep; x/d/f have taus of tens to hundreds of ms everywhere on the AP
# (tau_d >= ~20 ms, tau_f >= ~100 ms, tau_x >= ~200 ms) and advance once
# per outer step at 10 dt = 0.2 ms — still 2.5x finer than the
# reference's own 0.5 ms slow-gate cadence for BR.  Cai was audited and
# stays per-substep: its update is two FMAs on the i_si already computed
# for V, so skipping it saves nothing.
FAST_GATES = ("m", "h", "j")
SLOW_GATES = ("x", "d", "f")

# -- membrane constants (Luo & Rudy 1991, Table 1 / text) --------------------
RTF = 26.71          # RT/F at 310 K, mV
K_O, K_I = 5.4, 145.0    # mM
NA_O, NA_I = 140.0, 18.0  # mM
PR_NAK = 0.01833     # Na/K permeability ratio in E_K

E_NA = RTF * float(np.log(NA_O / NA_I))                      # +54.8 mV
E_K = RTF * float(np.log((K_O + PR_NAK * NA_O) / (K_I + PR_NAK * NA_I)))
E_K1 = RTF * float(np.log(K_O / K_I))                        # -87.9 mV
E_KP = E_K1

G_NA = 23.0
G_SI = 0.09
G_K = 0.282 * float(np.sqrt(K_O / 5.4))
G_K1 = 0.6047 * float(np.sqrt(K_O / 5.4))
G_KP = 0.0183
G_B = 0.03921
E_B = -59.87
C_M = 1.0

# explicit-Euler stability/accuracy bound for the V update: the ~390 V/s
# upstroke moves ~8 mV per 0.02 ms substep already; beyond 0.05 ms the
# overshoot feeds exp(0.35 V) in beta_h and the integration blows up
DT_MAX = 0.05


def gate_rates(v, xp=jnp, which=GATES):
    """Alpha/beta pairs of the requested gates (Luo & Rudy 1991, p. 1510
    rate table; default all six).

    `xp` is jnp (traced path) or np (definition-time steady-state
    initialization).  The V = -47.13 singularity of alpha_m is removable
    (limit 3.2 ms^-1); h/j branch at V = -40 mV via where() with both
    branches evaluated — every sub-expression is finite in float32 over
    V in [-110, +70], so the unselected branch never poisons the lane.
    `which` lets the multi-rate step skip the slow-gate transcendentals
    on the substeps that freeze them.
    """
    out = {}
    if "m" in which:
        dm = v + 47.13
        a_m = xp.where(
            xp.abs(dm) < 1e-3, 3.2,
            0.32 * dm / (1.0 - xp.exp(-0.1 * dm)),
        )
        out["m"] = (a_m, 0.08 * xp.exp(-v / 11.0))

    if "h" in which or "j" in which:
        lo = v < -40.0
    if "h" in which:
        a_h = xp.where(lo, 0.135 * xp.exp(-(80.0 + v) / 6.8), 0.0)
        b_h = xp.where(
            lo,
            3.56 * xp.exp(0.079 * v) + 3.1e5 * xp.exp(0.35 * v),
            1.0 / (0.13 * (1.0 + xp.exp(-(v + 10.66) / 11.1))),
        )
        out["h"] = (a_h, b_h)
    if "j" in which:
        a_j = xp.where(
            lo,
            (-1.2714e5 * xp.exp(0.2444 * v)
             - 3.474e-5 * xp.exp(-0.04391 * v))
            * (v + 37.78) / (1.0 + xp.exp(0.311 * (v + 79.23))),
            0.0,
        )
        b_j = xp.where(
            lo,
            0.1212 * xp.exp(-0.01052 * v)
            / (1.0 + xp.exp(-0.1378 * (v + 40.14))),
            0.3 * xp.exp(-2.535e-7 * v) / (1.0 + xp.exp(-0.1 * (v + 32.0))),
        )
        out["j"] = (a_j, b_j)

    if "d" in which:
        a_d = 0.095 * xp.exp(-0.01 * (v - 5.0)) / (
            1.0 + xp.exp(-0.072 * (v - 5.0)))
        b_d = 0.07 * xp.exp(-0.017 * (v + 44.0)) / (
            1.0 + xp.exp(0.05 * (v + 44.0)))
        out["d"] = (a_d, b_d)
    if "f" in which:
        a_f = 0.012 * xp.exp(-0.008 * (v + 28.0)) / (
            1.0 + xp.exp(0.15 * (v + 28.0)))
        b_f = 0.0065 * xp.exp(-0.02 * (v + 30.0)) / (
            1.0 + xp.exp(-0.2 * (v + 30.0)))
        out["f"] = (a_f, b_f)
    if "x" in which:
        a_x = 0.0005 * xp.exp(0.083 * (v + 50.0)) / (
            1.0 + xp.exp(0.057 * (v + 50.0)))
        b_x = 0.0013 * xp.exp(-0.06 * (v + 20.0)) / (
            1.0 + xp.exp(-0.04 * (v + 20.0)))
        out["x"] = (a_x, b_x)
    return out


def xi_factor(v, xp=jnp):
    """The time-independent inactivation factor Xi of I_K: for
    V > -100 mV, 2.837 (e^{0.04(V+77)} - 1) / ((V+77) e^{0.04(V+35)}),
    else 1.  The V = -77 singularity is removable (limit
    2.837 * 0.04 * e^{1.68})."""
    xi = xp.where(
        v > -100.0,
        2.837 * (xp.exp(0.04 * (v + 77.0)) - 1.0)
        / ((v + 77.0) * xp.exp(0.04 * (v + 35.0))),
        1.0,
    )
    lim = 2.837 * 0.04 * float(np.exp(1.68))
    return xp.where(xp.abs(v + 77.0) < 1e-3, lim, xi)


def k1_inf(v, xp=jnp):
    """Steady-state activation of the inward rectifier I_K1 (the gate is
    instantaneous: alpha/(alpha+beta) evaluated, never integrated)."""
    dv = v - E_K1
    a = 1.02 / (1.0 + xp.exp(0.2385 * (dv - 59.215)))
    b = (
        0.49124 * xp.exp(0.08032 * (dv + 5.476))
        + xp.exp(0.06175 * (dv - 594.31))
    ) / (1.0 + xp.exp(-0.5143 * (dv + 4.753)))
    return a / (a + b)


class LuoRudy91(IonicModel):
    name = "lr1"
    min_v = -90.0
    max_v = 50.0
    depol = -84.5
    dt_per_step = 10
    pot_key = "V"
    default_dt = 0.02
    # slow-inward conductance, overridable per instance (a trace-time
    # constant): the classic LR91 spiral/breakup literature tunes g_si
    # down from the paper's 0.09 to shorten APD — e.g. Qu, Weiss &
    # Garfinkel, Am J Physiol 1999 use 0.045 (APD ~200 ms) and 0
    # (~50 ms); examples/lr1_spiral.py drives this
    g_si = G_SI
    # channel-block (drug) interface (models/base.set_scale /
    # SimConfig.g_scale); g_si composes with the instance attribute
    # (scale x the tuned base) — and gives the classic tuning a
    # config-reachable spelling: SimConfig(g_scale={"g_si": 0.5}) is
    # exactly the literature's g_si = 0.045
    SCALE_PARAMS = ("g_Na", "g_si", "g_K", "g_K1", "g_Kp", "g_b")
    # Cai feeds log() in E_si — the adaptive-dt acceptance test keeps it
    # strictly positive (ops/adaptive.py)
    positive_states = ("Cai",)

    def __init__(self, cfg: SimConfig):
        super().__init__(cfg)
        if cfg.dt > DT_MAX and cfg.adaptive_dv is None:
            raise ValueError(
                f"LuoRudy91 is explicit-Euler unstable at dt={cfg.dt} "
                f"(g_Na=23 gives ~390 V/s upstrokes); use dt <= {DT_MAX} "
                "(0.02 recommended) or enable adaptive_dv step-doubling"
            )

    # -- state ------------------------------------------------------------------

    def state_keys(self):
        return ("Cai", "V", "d", "f", "h", "j", "m", "x")

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        """Rest at the paper's initial conditions: V = -84.5 mV,
        [Ca]i = 2e-4 mM, gates at their V-rest steady states (computed
        from the rate functions, so they stay consistent with any rate
        edit).  S1 is a 1-column +20 mV stripe, the Beeler-Reuter S1
        pattern (reference br.py:81-82) at a suprathreshold level."""
        v_rest = -84.5
        v = self._full(v_rest)
        if s1:
            v[:, 1] = 20.0
        st = {"V": v, "Cai": self._full(2e-4)}
        rates = gate_rates(np.float64(v_rest), xp=np)
        for g, (a, b) in rates.items():
            st[g] = self._full(float(a / (a + b)))
        return st

    # -- dynamics ---------------------------------------------------------------

    def currents(self, v0, cai, gates):
        """The six membrane currents (Luo & Rudy 1991, eqs. in Table 1):
        fast sodium, slow inward (Ca), time-dependent K, inward-rectifier
        K1, plateau K, and background.  Gates are the PRE-update planes
        (the zoo's Beeler-Reuter ordering convention, br.py:160-168)."""
        i_na = (self.gscale("g_Na", G_NA)
                * gates["m"] ** 3 * gates["h"] * gates["j"] * (v0 - E_NA))
        e_si = 7.7 - 13.0287 * jnp.log(cai)
        i_si = (self.gscale("g_si", self.g_si)
                * gates["d"] * gates["f"] * (v0 - e_si))
        i_k = self.gscale("g_K", G_K) * gates["x"] * xi_factor(v0) * (v0 - E_K)
        i_k1 = self.gscale("g_K1", G_K1) * k1_inf(v0) * (v0 - E_K1)
        kp = 1.0 / (1.0 + jnp.exp((7.488 - v0) / 5.98))
        i_kp = self.gscale("g_Kp", G_KP) * kp * (v0 - E_KP)
        i_b = self.gscale("g_b", G_B) * (v0 - E_B)
        return i_na, i_si, i_k, i_k1, i_kp, i_b

    def solve(self, state: State, geom: Geometry, n: int = 1) -> State:
        """One substep: Rush-Larsen on the gates, explicit Euler on V
        (reaction + diffusion) and on the Ca pool
        d[Ca]i/dt = -1e-4 I_si + 0.07 (1e-4 - [Ca]i).

        `n` is how many dt the slow x/d/f gates advance (0 = frozen —
        the multi-rate trick, reference br.py:125-173 form); the fast
        m/h/j Na gates always advance one dt."""
        dt = self.cfg.dt
        v0 = geom.enforce_boundary(state["V"])
        cai = state["Cai"]

        out = {}
        for g, (a, b) in gate_rates(v0, which=FAST_GATES).items():
            tau = 1.0 / (a + b)
            out[g] = rush_larsen(state[g], a * tau, tau, dt)
        if n > 0:
            for g, (a, b) in gate_rates(v0, which=SLOW_GATES).items():
                tau = 1.0 / (a + b)
                out[g] = rush_larsen(state[g], a * tau, tau, dt * n)
        else:
            for g in SLOW_GATES:
                out[g] = state[g]

        i_na, i_si, i_k, i_k1, i_kp, i_b = self.currents(v0, cai, state)
        i_sum = i_na + i_si + i_k + i_k1 + i_kp + i_b

        out["V"] = (
            v0 + self.cfg.diff * dt * geom.laplace(v0) - dt * i_sum / C_M
        )
        out["Cai"] = cai + dt * (-1e-4 * i_si + 0.07 * (1e-4 - cai))
        return out

    @property
    def has_uniform_substeps(self) -> bool:
        """Without `skip` the 10 substeps are identical solve(n=1) calls;
        the skip schedule (one n=10 + nine n=0) is not splittable at
        arbitrary boundaries."""
        return not self.cfg.skip and self.cfg.adaptive_dv is None

    def step(self, state: State, geom: Geometry,
             unroll: bool = True) -> State:
        """One outer step = 10 substeps; with `skip`, the first substep
        advances the slow x/d/f gates 10 dt and the rest freeze them
        (the reference's BR multi-rate schedule, br.py:96-107, applied
        to the model that needs it most — VERDICT r3 #2)."""
        from fib_tf_tpu.models.base import repeat_substeps

        k = self.dt_per_step
        if self.cfg.adaptive_dv is not None:
            # step-doubling: each substep keeps its skip-group `n` — a
            # refined n=10 substep becomes two half-dt n=10 solves, so
            # the slow gates still advance 2 x 10 x dt/2 = 10 dt
            def sub(n):
                return self.adaptive_substep(
                    geom, lambda m, s: m.solve(s, geom, n=n)
                )

            if self.cfg.skip:
                state = sub(k)(state)
                return repeat_substeps(sub(0), state, k - 1, unroll)
            return repeat_substeps(sub(1), state, k, unroll)
        if self.cfg.skip:
            state = self.solve(state, geom, n=k)
            return repeat_substeps(
                lambda s: self.solve(s, geom, n=0), state, k - 1, unroll
            )
        return repeat_substeps(
            lambda s: self.solve(s, geom, n=1), state, k, unroll
        )
