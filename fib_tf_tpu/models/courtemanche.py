"""The Courtemanche-Ramirez-Nattel human atrial model (21 variables).

Courtemanche M, Ramirez RJ, Nattel S. "Ionic mechanisms underlying human
atrial action potential properties: insights from a mathematical model."
Am J Physiol. 1998;275:H301-21.

Parity targets: reference court.py:31-429 (Python/TF) and the native CUDA
implementation courtemanche.h:58-479.  Includes:

  * chronic-AF remodeling: i_to and i_Kur scaled x0.5, i_Ca_L x0.3
    (court.py:193-194, 218; courtemanche.h:382-385, 404-405);
  * host-driven multi-rate: fast states (V, Na_i, m, h) advance every dt,
    the other 17 advance every 10th substep with dt*10
    (court.py:42, 94-103, 118-122, 616) — here the 10-substep group is
    fused into one outer step so the multi-rate dance happens inside the
    compiled scan, with XLA dead-code elimination playing the role of TF's
    graph pruning (the fast-only substep never computes slow updates);
  * lookup-table variant (`cfg.table`): the 30 voltage-dependent
    intermediates come from a 150-row, 1 mV-resolution table
    (courtemanche.h:352-357) instead of being evaluated pointwise;
  * the `CourtemancheUltra` subclass: adds the ultra-slow Na-current gate
    `us` and disables the fast/slow split (court_ultra.py:81-132, 198-222,
    445-450).

`calc_intermediates` runs under numpy (table generation, 0D tests) or jnp
(traced), mirroring the reference's dual-mode `calc_inter(V, mod)`
(court.py:273-429).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models.base import Geometry, IonicModel, State
from fib_tf_tpu.ops import table as table_ops
from fib_tf_tpu.ops.integrators import euler, rush_larsen

# -- physical constants (Courtemanche et al. 1998; court.py:129-163) ----------
R_GAS = 8.3143        # J/(mol K)
TEMP = 310.0          # K
FARADAY = 96.4867     # C/mmol
CM = 100.0            # pF
G_NA = 7.8
NA_O = 140.0
K_O = 5.4
G_TO = 0.1652
G_KS = 0.12941176
G_CA_L = 0.12375
KM_NA_I = 10.0
KM_K_O = 1.5
I_NAK_MAX = 0.59933874
I_CAP_MAX = 0.275
G_B_NA = 0.0006744375
G_B_CA = 0.001131
G_B_K = 0.0
CA_O = 1.8
K_REL = 30.0
TAU_TR = 180.0
I_UP_MAX = 0.005
K_UP = 0.00092
CA_UP_MAX = 15.0
CMDN_MAX = 0.05
TRPN_MAX = 0.07
CSQN_MAX = 10.0
KM_CMDN = 0.00238
KM_TRPN = 0.0005
KM_CSQN = 0.8
V_CELL = 20100.0
V_I = V_CELL * 0.68
TAU_F_CA = 2.0
TAU_U = 8.0
V_REL = 0.0048 * V_CELL
V_UP = 0.0552 * V_CELL

# calc_intermediates constants (court.py:274-288)
G_K1 = 0.09
K_Q10 = 3.0
G_KR = 0.029411765
I_NACA_MAX = 1600.0
K_M_NA = 87.5
K_M_CA = 1.38
K_SAT = 0.1
GAMMA = 0.35
SIGMA = 1.0

# Ultra-slow Na gate (court_ultra.py:445-450)
V_US = -83.0
K_US = 23.0

# Column order of the native lookup table (courtemanche.h:105-134).
INTER_KEYS = (
    "d_infinity", "f_infinity", "tau_w", "tau_d", "tau_f", "w_infinity",
    "m_inf", "h_inf", "j_inf", "tau_oa", "tau_oi", "tau_ua", "tau_ui",
    "tau_xr", "tau_xs", "tau_m", "tau_h", "tau_j", "oa_infinity",
    "oi_infinity", "ua_infinity", "ui_infinity", "xr_infinity",
    "xs_infinity", "g_Kur", "f_NaK", "i_NaCaa", "i_NaCab", "i_K1a", "i_Kra",
)

FAST_STATES = ("V", "Na_i", "m", "h")  # court.py:42
SLOW_RATIO = 10                        # court.py:118-122, 616


def calc_intermediates(v, xp=jnp, ultra_slow: bool = False) -> Dict:
    """The 30 voltage-dependent intermediates (court.py:273-429).

    `xp` is numpy or jax.numpy.  The `eps = V*1e-20` terms reproduce the
    reference's singularity guards, which keep the removable-singularity
    branches well-defined under vectorized `where` evaluation.
    """
    rt = R_GAS * TEMP
    inter = {}
    eps = v * 1e-20

    inter["d_infinity"] = 1.0 / (1.0 + xp.exp((v + 10.0) / -8.0))
    # V+10 shifted to V+10.0001 in the non-singular branch, as court.py:302-307
    inter["tau_d"] = xp.where(
        xp.abs(v + 10.0001) < 1.0e-10,
        4.579 / (1.0 + xp.exp((v + 10.0) / -6.24)),
        (1.0 - xp.exp((v + 10.0001) / -6.24))
        / (0.035 * (v + 10.0001) * (1.0 + xp.exp((v + 10.0001) / -6.24))),
    )

    inter["f_infinity"] = xp.exp(-(v + 28.0) / 6.9) / (
        1.0 + xp.exp(-(v + 28.0) / 6.9)
    )
    inter["tau_f"] = 9.0 / (
        0.0197 * xp.exp(-(0.0337**2) * (v + 10.0) ** 2) + 0.02
    )

    inter["tau_w"] = xp.where(
        xp.abs(v - 7.9) < 1.0e-10,
        eps + (6.0 * 0.2) / 1.3,
        (6.0 * (1.0 - xp.exp(-(v - 7.9) / 5.0)))
        / ((1.0 + 0.3 * xp.exp(-(v - 7.9) / 5.0)) * (v - 7.9)),
    )
    inter["w_infinity"] = 1.0 - 1.0 / (1.0 + xp.exp(-(v - 40.0) / 17.0))

    alpha_m = xp.where(
        xp.abs(v + 47.13) < 0.001,
        eps + 3.2,
        (0.32 * (v + 47.13)) / (1.0 - xp.exp(-0.1 * (v + 47.13))),
    )
    beta_m = 0.08 * xp.exp(-v / 11.0)
    inter["m_inf"] = alpha_m / (alpha_m + beta_m)
    inter["tau_m"] = 1.0 / (alpha_m + beta_m)

    alpha_h = xp.where(v < -40.0, 0.135 * xp.exp((v + 80.0) / -6.8), eps)
    beta_h = xp.where(
        v < -40.0,
        3.56 * xp.exp(0.079 * v) + 310000.0 * xp.exp(0.35 * v),
        1.0 / (0.13 * (1.0 + xp.exp((v + 10.66) / -11.1))),
    )
    inter["h_inf"] = alpha_h / (alpha_h + beta_h)
    inter["tau_h"] = 1.0 / (alpha_h + beta_h)

    alpha_j = xp.where(
        v < -40.0,
        (
            (-127140.0 * xp.exp(0.2444 * v) - 3.474e-05 * xp.exp(-0.04391 * v))
            * (v + 37.78)
        )
        / (1.0 + xp.exp(0.311 * (v + 79.23))),
        eps,
    )
    beta_j = xp.where(
        v < -40.0,
        (0.1212 * xp.exp(-0.01052 * v))
        / (1.0 + xp.exp(-0.1378 * (v + 40.14))),
        (0.3 * xp.exp(-2.535e-07 * v)) / (1.0 + xp.exp(-0.1 * (v + 32.0))),
    )
    inter["j_inf"] = alpha_j / (alpha_j + beta_j)
    inter["tau_j"] = 1.0 / (alpha_j + beta_j)

    # transient outward (oa/oi) and ultrarapid (ua/ui) K gates all use the
    # shifted voltage (V + 10)
    vs = v + 10.0
    alpha_oa = 0.65 / (xp.exp(vs / -8.5) + xp.exp((vs - 40.0) / -59.0))
    beta_oa = 0.65 / (2.5 + xp.exp((vs + 72.0) / 17.0))
    inter["tau_oa"] = 1.0 / (alpha_oa + beta_oa) / K_Q10
    inter["oa_infinity"] = 1.0 / (1.0 + xp.exp((vs + 10.47) / -17.54))

    alpha_oi = 1.0 / (18.53 + xp.exp((vs + 103.7) / 10.95))
    beta_oi = 1.0 / (35.56 + xp.exp((vs - 8.74) / -7.44))
    inter["tau_oi"] = 1.0 / (alpha_oi + beta_oi) / K_Q10
    inter["oi_infinity"] = 1.0 / (1.0 + xp.exp((vs + 33.1) / 5.3))

    alpha_ua = 0.65 / (xp.exp(vs / -8.5) + xp.exp((vs - 40.0) / -59.0))
    beta_ua = 0.65 / (2.5 + xp.exp((vs + 72.0) / 17.0))
    inter["tau_ua"] = 1.0 / (alpha_ua + beta_ua) / K_Q10
    inter["ua_infinity"] = 1.0 / (1.0 + xp.exp((vs + 20.3) / -9.6))

    alpha_ui = 1.0 / (21.0 + xp.exp((vs - 195.0) / -28.0))
    beta_ui = 1.0 / xp.exp((vs - 168.0) / -16.0)
    inter["tau_ui"] = 1.0 / (alpha_ui + beta_ui) / K_Q10
    inter["ui_infinity"] = 1.0 / (1.0 + xp.exp((vs - 109.45) / 27.48))

    alpha_xr = xp.where(
        xp.abs(v + 14.1) < 1.0e-10,
        eps + 0.0015,
        (0.0003 * (v + 14.1)) / (1.0 - xp.exp((v + 14.1) / -5.0)),
    )
    beta_xr = xp.where(
        xp.abs(v - 3.3328) < 1.0e-10,
        eps + 0.000378361,
        (7.3898e-05 * (v - 3.3328)) / (xp.exp((v - 3.3328) / 5.1237) - 1.0),
    )
    inter["tau_xr"] = 1.0 / (alpha_xr + beta_xr)
    inter["xr_infinity"] = 1.0 / (1.0 + xp.exp((v + 14.1) / -6.5))

    alpha_xs = xp.where(
        xp.abs(v - 19.9) < 1.0e-10,
        eps + 0.00068,
        (4.0e-05 * (v - 19.9)) / (1.0 - xp.exp((v - 19.9) / -17.0)),
    )
    beta_xs = xp.where(
        xp.abs(v - 19.9) < 1.0e-10,
        eps + 0.000315,
        (3.5e-05 * (v - 19.9)) / (xp.exp((v - 19.9) / 9.0) - 1.0),
    )
    inter["tau_xs"] = 0.5 / (alpha_xs + beta_xs)
    inter["xs_infinity"] = xp.sqrt(1.0 / (1.0 + xp.exp((v - 19.9) / -12.7)))

    inter["g_Kur"] = 0.005 + 0.05 / (1.0 + xp.exp((v - 15.0) / -13.0))

    inter["f_NaK"] = 1.0 / (
        1.0
        + 0.1245 * xp.exp((-0.1 * FARADAY * v) / rt)
        + 0.0365 * SIGMA * xp.exp((-FARADAY * v) / rt)
    )

    i_na_ca_den = (
        (K_M_NA**3 + NA_O**3)
        * (K_M_CA + CA_O)
        * (1.0 + K_SAT * xp.exp(((GAMMA - 1.0) * v * FARADAY) / rt))
    )
    inter["i_NaCaa"] = (
        CM * I_NACA_MAX * (xp.exp((GAMMA * FARADAY * v) / rt) * CA_O)
    ) / i_na_ca_den
    inter["i_NaCab"] = (
        CM * I_NACA_MAX * (xp.exp(((GAMMA - 1.0) * FARADAY * v) / rt) * NA_O**3)
    ) / i_na_ca_den

    inter["i_K1a"] = (CM * G_K1) / (1.0 + xp.exp(0.07 * (v + 80.0)))
    inter["i_Kra"] = (CM * G_KR) / (1.0 + xp.exp((v + 15.0) / 22.4))

    if ultra_slow:
        inter["us_infinity"], inter["tau_us"] = us_rates(v, xp)

    return inter


def us_rates(v, xp=jnp):
    """Ultra-slow gate inf/tau from the tanh-shaped alpha/beta rates
    (reference court_ultra.py:445-450)."""
    alpha_us = 3e-5 * (0.5 * (1.0 - xp.tanh((v - V_US) / K_US)))
    beta_us = 1e-5 * (0.5 * (1.0 + xp.tanh((v - (V_US + 30.0)) / K_US)))
    return alpha_us / (alpha_us + beta_us), 1.0 / (alpha_us + beta_us)


def calc_intermediates_np(v: np.ndarray) -> Dict[str, np.ndarray]:
    """Numpy wrapper used by table building and tests."""
    return calc_intermediates(np.asarray(v, dtype=np.float64), xp=np)


# Keys whose V-dependence is smooth enough for a polynomial fit.  The fast
# Na h/j rates are excluded: their alpha/beta switch branches at V = -40 mV
# (court.py:331-355) and a global polynomial would ring at the kink — the
# reason the reference's own Courtemanche-Chebyshev experiment was
# abandoned as dead code (court.py:463-477).  The hybrid here fits the
# smooth 24 and keeps h/j (and the ultra-slow gate) direct.
CHEBY_SMOOTH_KEYS = tuple(
    k for k in INTER_KEYS
    if k not in ("h_inf", "tau_h", "j_inf", "tau_j")
)
CHEBY_DEG_COURT = 12      # the reference's dead-code experiment used 12
CHEBY_SAMPLES_COURT = 5001  # (court.py:470-472)


def calc_hj_rates(v, xp=jnp) -> Dict:
    """Just the branchy fast-Na h/j inactivation rates (court.py:331-359),
    for the hybrid Chebyshev path."""
    eps = v * 1e-20
    out = {}
    alpha_h = xp.where(v < -40.0, 0.135 * xp.exp((v + 80.0) / -6.8), eps)
    beta_h = xp.where(
        v < -40.0,
        3.56 * xp.exp(0.079 * v) + 310000.0 * xp.exp(0.35 * v),
        1.0 / (0.13 * (1.0 + xp.exp((v + 10.66) / -11.1))),
    )
    out["h_inf"] = alpha_h / (alpha_h + beta_h)
    out["tau_h"] = 1.0 / (alpha_h + beta_h)

    alpha_j = xp.where(
        v < -40.0,
        (
            (-127140.0 * xp.exp(0.2444 * v) - 3.474e-05 * xp.exp(-0.04391 * v))
            * (v + 37.78)
        )
        / (1.0 + xp.exp(0.311 * (v + 79.23))),
        eps,
    )
    beta_j = xp.where(
        v < -40.0,
        (0.1212 * xp.exp(-0.01052 * v))
        / (1.0 + xp.exp(-0.1378 * (v + 40.14))),
        (0.3 * xp.exp(-2.535e-07 * v)) / (1.0 + xp.exp(-0.1 * (v + 32.0))),
    )
    out["j_inf"] = alpha_j / (alpha_j + beta_j)
    out["tau_j"] = 1.0 / (alpha_j + beta_j)
    return out


class Courtemanche(IonicModel):
    name = "court"
    min_v = -100.0
    max_v = 50.0
    depol = -81.0
    # One outer step fuses a full fast/slow multi-rate group of 10 dt
    # substeps (the reference drove this from the host, court.py:616).
    dt_per_step = SLOW_RATIO
    pot_key = "V"
    fast_states: Tuple[str, ...] = FAST_STATES
    # concentrations feeding Nernst logs / sqrt — the adaptive-dt
    # acceptance test keeps them strictly positive (ops/adaptive.py)
    positive_states: Tuple[str, ...] = (
        "Ca_i", "Ca_rel", "Ca_up", "Na_i", "K_i",
    )
    ultra_slow = False
    # per-pixel heterogeneity (VERDICT r4 #1b): a [0, 1] plane that
    # spatializes the reference's GLOBAL chronic-AF remodeling flag
    # (court.py:193-194, 218 — i_to/i_Kur x(1-0.5c), i_Ca_L x(1-0.7c))
    # into regional remodeling; 1 = fully remodeled, 0 = healthy, and
    # intermediate values model the gray-zone border.  Overrides
    # cfg.chronic where attached (models/base.set_het).
    HET_PARAMS = ("chronic",)
    # channel-block (drug) interface (models/base.set_scale /
    # SimConfig.g_scale); composes multiplicatively with the chronic
    # remodeling factor (global flag or per-pixel plane)
    SCALE_PARAMS = ("g_Na", "g_CaL", "g_Kr", "g_Ks", "g_to", "g_Kur",
                    "g_K1", "g_NaK", "g_NaCa", "g_pCa", "g_bNa", "g_bCa",
                    "g_bK")

    INITIAL_VALUES = {
        # court.py:57-78 / courtemanche.h:58-103
        "V": -81.18,
        "Na_i": 1.117e01,
        "m": 2.98e-3,
        "h": 9.649e-1,
        "j": 9.775e-1,
        "K_i": 1.39e02,
        "oa": 3.043e-2,
        "oi": 9.992e-1,
        "ua": 4.966e-3,
        "ui": 9.986e-1,
        "xr": 3.296e-5,
        "xs": 1.869e-2,
        "Ca_i": 1.013e-4,
        "d": 1.367e-4,
        "f": 9.996e-1,
        "f_Ca": 7.755e-1,
        "Ca_rel": 1.488,
        "u_gate": 0.0,
        "v_gate": 1.0,
        "w_gate": 0.9992,
        "Ca_up": 1.488,
    }

    # gates updated from fitted (smooth) rate curves: gate -> (inf, tau,
    # dt-key) — w advances with d's dt, a preserved reference quirk
    # (court.py:177)
    FITTED_GATES = {
        "d": ("d_infinity", "tau_d", "d"),
        "f": ("f_infinity", "tau_f", "f"),
        "w_gate": ("w_infinity", "tau_w", "d"),
        "m": ("m_inf", "tau_m", "m"),
        "oa": ("oa_infinity", "tau_oa", "oa"),
        "oi": ("oi_infinity", "tau_oi", "oi"),
        "ua": ("ua_infinity", "tau_ua", "ua"),
        "ui": ("ui_infinity", "tau_ui", "ui"),
        "xr": ("xr_infinity", "tau_xr", "xr"),
        "xs": ("xs_infinity", "tau_xs", "xs"),
    }

    def __init__(self, cfg: SimConfig):
        super().__init__(cfg)
        if cfg.ab2:
            raise NotImplementedError(
                "ab2 is not implemented for Courtemanche: the multi-rate "
                "fast/slow split advances states on different effective "
                "dts, which has no well-defined shared AB2 history; use "
                "fenton or br"
            )
        self._table: Optional[jnp.ndarray] = None
        self._cheby: Optional[Dict[str, np.ndarray]] = None
        if cfg.table:
            tbl = table_ops.build_table(calc_intermediates_np, INTER_KEYS)
            self._table = jnp.asarray(tbl)
        elif cfg.court_cheby:
            self._cheby = self._fit_chebyshev()

    def _fit_chebyshev(self) -> Dict[str, np.ndarray]:
        """Hybrid Chebyshev: degree-12 fits of the 24 smooth intermediates
        (the branchy h/j rates stay direct — see CHEBY_SMOOTH_KEYS), plus
        folded Rush-Larsen multipliers expm1(-dt_g/tau(V)) for every fitted
        gate when cheby_fold is on."""
        from fib_tf_tpu.ops.chebyshev import chebyshev_fit

        v = np.linspace(self.min_v, self.max_v, CHEBY_SAMPLES_COURT)
        inter = calc_intermediates_np(v)
        coef = {
            k: chebyshev_fit(v, np.broadcast_to(inter[k], v.shape),
                             CHEBY_DEG_COURT)
            for k in CHEBY_SMOOTH_KEYS
        }
        if self.cfg.cheby_fold:
            for gate, (_inf, tau_key, dt_key) in self.FITTED_GATES.items():
                r = np.expm1(-self.dt_for(dt_key) / inter[tau_key])
                coef[f"rl_{gate}"] = chebyshev_fit(v, r, CHEBY_DEG_COURT)
        return coef

    # -- state ------------------------------------------------------------------

    def state_keys(self):
        """Literal key tuple (ADVICE r2: the base-class default would
        materialize 21 full H x W planes just for metadata)."""
        keys = tuple(self.INITIAL_VALUES.keys())
        if self.ultra_slow:
            keys = keys + ("us",)
        return tuple(sorted(keys + self.het_keys()))

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        state = {k: self._full(val) for k, val in self.INITIAL_VALUES.items()}
        if self.ultra_slow:
            state["us"] = self._full(0.72)  # steady state at 500 ms
        if s1:
            state["V"][:, :25] = 20.0  # 25-px left stripe (court.py:80-82)
        return self.attach_het(state)

    # -- multi-rate -------------------------------------------------------------

    def dt_for(self, name: str) -> float:
        """Per-state integration step: fast states use dt, the rest dt*10
        (court.py:118-122)."""
        if name in self.fast_states:
            return self.cfg.dt
        return self.cfg.dt * SLOW_RATIO

    # -- dynamics ---------------------------------------------------------------

    def intermediates(self, v) -> Dict[str, jnp.ndarray]:
        if self._table is not None:
            inter = table_ops.lookup(self._table, v, INTER_KEYS)
            if self.ultra_slow:
                # the native 30-column table has no us entries; evaluate
                # those two directly
                extra = calc_intermediates(v, xp=jnp, ultra_slow=True)
                inter["us_infinity"] = extra["us_infinity"]
                inter["tau_us"] = extra["tau_us"]
            return inter
        if self._cheby is not None:
            from fib_tf_tpu.ops.chebyshev import (
                chebyshev_eval, chebyshev_terms, normalize_voltage,
            )

            x = normalize_voltage(v, self.min_v, self.max_v)
            terms = chebyshev_terms(x, CHEBY_DEG_COURT)
            inter = {k: chebyshev_eval(c, terms)
                     for k, c in self._cheby.items()}
            inter.update(calc_hj_rates(v, xp=jnp))
            if self.ultra_slow:
                extra = calc_intermediates(v, xp=jnp, ultra_slow=True)
                inter["us_infinity"] = extra["us_infinity"]
                inter["tau_us"] = extra["tau_us"]
            return inter
        return calc_intermediates(v, xp=jnp, ultra_slow=self.ultra_slow)

    def _gate(self, state: State, inter, gate: str) -> jnp.ndarray:
        """One gate update: folded multiplier when fitted, else
        Rush-Larsen."""
        inf_key, tau_key, dt_key = self.FITTED_GATES[gate]
        g = state[gate]
        rl_key = f"rl_{gate}"
        if rl_key in inter:
            from fib_tf_tpu.ops.integrators import GATE_MAX, GATE_MIN

            return jnp.clip(
                g + (g - inter[inf_key]) * inter[rl_key], GATE_MIN, GATE_MAX
            )
        return rush_larsen(g, inter[inf_key], inter[tau_key],
                           self.dt_for(dt_key))

    def solve_full(self, state: State, geom: Geometry):
        """One substep; returns (new_state, intermediates).

        Mirrors court.py:124-271 term by term.  When traced for a fast-only
        update, XLA dead-code-eliminates the slow-state computations (the
        functional analog of TF pruning the `_ode_op` fetch subgraph).
        """
        dt_ = self.dt_for
        rt_f = (R_GAS * TEMP) / FARADAY
        # regional remodeling plane when attached (set_het), else the
        # reference's global flag (court.py:167-170)
        chronic = self.het_param(
            state, "chronic", 1.0 if self.cfg.chronic else 0.0
        )

        v = geom.enforce_boundary(state["V"])
        inter = self.intermediates(v)

        s1: State = {}
        # the ten fitted gates (w advances with d's dt — a preserved
        # reference quirk, court.py:177; see FITTED_GATES)
        for gate in self.FITTED_GATES:
            s1[gate] = self._gate(state, inter, gate)
        # fast-Na inactivation stays on the direct branchy rates
        s1["h"] = rush_larsen(state["h"], inter["h_inf"], inter["tau_h"], dt_("h"))
        s1["j"] = rush_larsen(state["j"], inter["j_inf"], inter["tau_j"], dt_("j"))
        if self.ultra_slow:
            s1["us"] = rush_larsen(state["us"], inter["us_infinity"], inter["tau_us"], dt_("us"))

        f_ca_inf = 1.0 / (1.0 + state["Ca_i"] / 0.00035)
        s1["f_Ca"] = rush_larsen(state["f_Ca"], f_ca_inf, TAU_F_CA, dt_("f_Ca"))

        e_k = rt_f * jnp.log(K_O / state["K_i"])
        i_k1 = self.gscale("g_K1", inter["i_K1a"]) * (v - e_k)
        i_to = (1.0 - 0.5 * chronic) * CM * self.gscale("g_to", G_TO) * state["oa"] ** 3 * state["oi"] * (v - e_k)
        i_kur = (1.0 - 0.5 * chronic) * CM * self.gscale("g_Kur", inter["g_Kur"]) * state["ua"] ** 3 * state["ui"] * (v - e_k)
        i_kr = self.gscale("g_Kr", inter["i_Kra"]) * state["xr"] * (v - e_k)
        i_ks = CM * self.gscale("g_Ks", G_KS) * state["xs"] ** 2 * (v - e_k)
        i_nak = (
            (CM * self.gscale("g_NaK", I_NAK_MAX) * inter["f_NaK"])
            / (1.0 + jnp.sqrt((KM_NA_I / state["Na_i"]) ** 3))
        ) * (K_O / (K_O + KM_K_O))
        i_b_k = CM * self.gscale("g_bK", G_B_K) * (v - e_k)

        s1["K_i"] = euler(
            state["K_i"],
            (2.0 * i_nak - (i_k1 + i_to + i_kur + i_kr + i_ks + i_b_k)) / (V_I * FARADAY),
            dt_("K_i"),
        )

        e_na = rt_f * jnp.log(NA_O / state["Na_i"])
        i_na = CM * self.gscale("g_Na", G_NA) * state["m"] ** 3 * state["h"] * state["j"] * (v - e_na)
        if self.ultra_slow:
            i_na = i_na * state["us"]  # court_ultra.py:221-222
        i_naca = self.gscale("g_NaCa", inter["i_NaCaa"] * state["Na_i"] ** 3 - inter["i_NaCab"] * state["Ca_i"])
        i_b_na = CM * self.gscale("g_bNa", G_B_NA) * (v - e_na)

        s1["Na_i"] = euler(
            state["Na_i"],
            (-3.0 * i_nak - (3.0 * i_naca + i_b_na + i_na)) / (V_I * FARADAY),
            dt_("Na_i"),
        )

        i_ca_l = (1.0 - 0.7 * chronic) * CM * self.gscale("g_CaL", G_CA_L) * state["d"] * state["f"] * state["f_Ca"] * (v - 65.0)
        i_cap = (CM * self.gscale("g_pCa", I_CAP_MAX) * state["Ca_i"]) / (0.0005 + state["Ca_i"])
        e_ca = (rt_f / 2.0) * jnp.log(CA_O / state["Ca_i"])
        i_b_ca = CM * self.gscale("g_bCa", G_B_CA) * (v - e_ca)

        dv = euler(
            v,
            -(i_na + i_k1 + i_to + i_kur + i_kr + i_ks + i_b_na + i_b_ca
              + i_nak + i_cap + i_naca + i_ca_l) / CM,
            dt_("V"),
        )
        v1 = dv + self.cfg.diff * dt_("V") * geom.laplace(v)
        if self.cfg.dv_max is not None:
            # opt-in stability guard for long fibrillatory runs: cap the
            # per-substep V change (the court analog of BR's reference
            # V-clip, br.py:167-168, which court.py lacked — its runs
            # could integrate off to NaN where the reference's disabled
            # NaN check, ionic.py:208-212, never noticed).  Off by
            # default for exact reference parity.
            v1 = v + jnp.clip(v1 - v, -self.cfg.dv_max, self.cfg.dv_max)
        s1["V"] = v1

        i_rel = K_REL * state["u_gate"] ** 2 * state["v_gate"] * state["w_gate"] * (
            state["Ca_rel"] - state["Ca_i"]
        )
        i_tr = (state["Ca_up"] - state["Ca_rel"]) / TAU_TR

        s1["Ca_rel"] = euler(
            state["Ca_rel"],
            (i_tr - i_rel)
            / (1.0 + (CSQN_MAX * KM_CSQN) / (state["Ca_rel"] + KM_CSQN) ** 2),
            dt_("Ca_rel"),
        )

        fn = 1000.0 * (
            1.0e-15 * V_REL * i_rel
            - (1.0e-15 / (2.0 * FARADAY)) * (0.5 * i_ca_l - 0.2 * i_naca)
        )
        u_inf = 1.0 / (1.0 + jnp.exp(-(fn - 3.4175e-13) / 1.367e-15))
        s1["u_gate"] = rush_larsen(state["u_gate"], u_inf, TAU_U, dt_("u_gate"))

        tau_v = 1.91 + 2.09 * u_inf
        v_inf = 1.0 - 1.0 / (1.0 + jnp.exp(-(fn - 6.835e-14) / 1.367e-15))
        s1["v_gate"] = rush_larsen(state["v_gate"], v_inf, tau_v, dt_("v_gate"))

        i_up = I_UP_MAX / (1.0 + K_UP / state["Ca_i"])
        i_up_leak = (I_UP_MAX * state["Ca_up"]) / CA_UP_MAX

        s1["Ca_up"] = euler(
            state["Ca_up"],
            i_up - (i_up_leak + (i_tr * V_REL) / V_UP),
            dt_("Ca_up"),
        )

        b1 = (2.0 * i_naca - (i_cap + i_ca_l + i_b_ca)) / (2.0 * V_I * FARADAY) + (
            V_UP * (i_up_leak - i_up) + i_rel * V_REL
        ) / V_I
        b2 = (
            1.0
            + (TRPN_MAX * KM_TRPN) / (state["Ca_i"] + KM_TRPN) ** 2
            + (CMDN_MAX * KM_CMDN) / (state["Ca_i"] + KM_CMDN) ** 2
        )
        s1["Ca_i"] = euler(state["Ca_i"], b1 / b2, dt_("Ca_i"))

        return s1, inter

    def solve(self, state: State, geom: Geometry) -> State:
        return self.carry_het(state, self.solve_full(state, geom)[0])

    def step(self, state: State, geom: Geometry,
             unroll: bool = True) -> State:
        """One fused fast/slow group of 10 dt substeps.

        Replicates the reference host schedule (court.py:615-619): at
        substep 0 the fast states commit, then the slow states commit from
        a second solve that sees the fast-updated values (two sess.runs in
        the reference); substeps 1-9 commit fast states only.
        `unroll=False` puts the 9 identical fast-only substeps under
        lax.fori_loop (models/base.repeat_substeps).
        """
        # het planes are neither fast nor slow: they pass through the
        # {**s, ...} spreads below untouched
        slow = [k for k in state if k not in self.fast_states
                and not k.startswith(self.HET_PREFIX)]

        if self.cfg.adaptive_dv is not None:
            # step-doubling on BOTH commit flavors.  Fast substeps refine
            # on the ΔV bound; the slow commit (effective dt x10 for the
            # Ca-release subsystem — exactly where long fibrillatory runs
            # went stiff in the reference) refines on finiteness and
            # concentration positivity, since V is not among its planes.
            # A refined slow commit takes two half-dt solves whose
            # dt_for(slow) is 5 x dt each, preserving the x10 total.
            fast_only = self.adaptive_substep(
                geom, commit_keys=self.fast_states
            )
            slow_commit = self.adaptive_substep(
                geom, commit_keys=tuple(slow)
            )
        else:
            def fast_only(s):
                s1 = self.solve(s, geom)
                return {**s, **{k: s1[k] for k in self.fast_states}}

            def slow_commit(s):
                s1 = self.solve(s, geom)
                return {**s, **{k: s1[k] for k in slow}}

        state = fast_only(state)
        state = slow_commit(state)
        if unroll:
            for _ in range(SLOW_RATIO - 1):
                state = fast_only(state)
            return state
        # fori_loop form: carry ONLY the fast planes — the 17 slow planes
        # (and any _p_ het planes) are loop-invariant and ride as
        # closed-over constants instead of per-iteration carries
        frozen = {k: state[k] for k in state
                  if k not in self.fast_states}

        def body(_, fast_s):
            s1 = fast_only({**frozen, **fast_s})
            return {k: s1[k] for k in self.fast_states}

        fast0 = {k: state[k] for k in self.fast_states}
        fast = jax.lax.fori_loop(0, SLOW_RATIO - 1, body, fast0)
        return {**frozen, **fast}

    @property
    def trend_points(self):
        """((state_key, row, col), ...) of the trend probe — the single
        source of truth shared by trend_probe (single-chip/GSPMD) and the
        shard_map masked-psum probe (parallel/spmd.py)."""
        w2 = self.cfg.width // 2
        return (("V", w2, 20), ("Na_i", w2, 20))

    def trend_probe(self, state: State) -> jnp.ndarray:
        """The on-graph trend probe: V and Na_i at pixel
        [width//2, 20] (court.py:107-112)."""
        return jnp.stack([state[k][r, c] for k, r, c in self.trend_points])


class CourtemancheUltra(Courtemanche):
    """court_ultra.py variant: ultra-slow Na gate, no fast/slow split.

    All 22 states advance every dt (court_ultra.py:107-110, 127-132); the
    extra `us` gate multiplies i_Na (court_ultra.py:221-222) and follows
    tanh-shaped alpha/beta rates (court_ultra.py:445-450).
    """

    name = "court_ultra"
    ultra_slow = True

    def __init__(self, cfg: SimConfig):
        super().__init__(cfg.replace(ultra_slow=True))

    def dt_for(self, name: str) -> float:
        return self.cfg.dt  # δt ≡ dt (court_ultra.py:127-132)

    def step(self, state: State, geom: Geometry,
             unroll: bool = True) -> State:
        # all states commit every substep; keep the 10-substep fusion for
        # host-loop amortization (fori_loop form when unroll=False)
        from fib_tf_tpu.models.base import repeat_substeps

        if self.cfg.adaptive_dv is not None:
            # single-rate model: the generic full-commit step-doubling
            # substep applies to all 22 planes
            return repeat_substeps(
                self.adaptive_substep(geom), state, SLOW_RATIO, unroll
            )
        return repeat_substeps(
            lambda s: self.solve(s, geom), state, SLOW_RATIO, unroll
        )

    @property
    def trend_points(self):
        """court_ultra probes V and us at [width//2, height//8]
        (court_ultra.py:116-121)."""
        r, c = self.cfg.width // 2, self.cfg.height // 8
        return (("V", r, c), ("us", r, c))

    def trend_probe(self, state: State) -> jnp.ndarray:
        return jnp.stack([state[k][r, c] for k, r, c in self.trend_points])

    # key order of the stacked `ultra` probe stream (engine _probes)
    ULTRA_KEYS = ("mean_na", "mean_ca", "mean_us",
                  "mean_us_infinity", "mean_tau_us")

    def ultra_observables(self, state: State, phase=None) -> jnp.ndarray:
        """Phase-weighted spatial means of the ultra-slow machinery — the
        quantities court_ultra's cl_observer logged from host-side
        variable/intermediate reads (court_ultra.py:465-486), computed
        on-device here as a [5] vector ordered by ULTRA_KEYS.

        Only the two us-gate rate fields are recomputed (us_rates), not the
        full 30-intermediate set — this rides the per-step probe stream."""
        v = state["V"]
        w = jnp.asarray(phase) if phase is not None else jnp.ones_like(v)
        wsum = jnp.sum(w)
        return jnp.stack([
            jnp.sum(x * w) / wsum for x in self.ultra_fields(state)
        ])

    def ultra_fields(self, state: State):
        """The five local planes whose phase-weighted means form the
        `ultra` probe (ULTRA_KEYS order) — exposed so the shard_map path
        can compute the same means as psums of local partial sums
        (parallel/spmd.py)."""
        us_inf, tau_us = us_rates(state["V"], jnp)
        return (state["Na_i"], state["f_Ca"], state["us"], us_inf, tau_us)
