"""Mitchell-Schaeffer 2-variable model — a zoo extension beyond the
reference's three families.

Mitchell CC, Schaeffer DG. "A two-current model for the dynamics of
cardiac membrane." Bull Math Biol. 2003 Sep;65(5):767-93.

Two planes: the normalized potential u (diffusing) and one recovery gate
h.  The inward current h·u²(1−u)/τ_in regenerates the upstroke; the
outward current u/τ_out repolarizes; h closes above the gate threshold
(τ_close) and reopens below it (τ_open).

Why it's in the zoo (no reference counterpart — reference fenton.py is
the smallest model it ships, 4 variables):

  * the gate ODE is piecewise-LINEAR in h, so its substep integrates
    EXACTLY (exponential relaxation toward 0 or 1 — the same
    Rush-Larsen form the big models approximate);
  * the paper gives closed-form tissue relations, giving this model the
    only *analytic* action-potential pin in the suite:
    APD_max = τ_close · ln(1/h_min) with h_min = 4·τ_in/τ_out
    (Mitchell & Schaeffer 2003, eq. 11-13) — tested in
    tests/test_mitchell_schaeffer.py;
  * at two planes it is the cheapest spiral-capable model, handy for
    big ensembles and 3D volumes.

Model contract matches the rest of the zoo (models/base.py): pure
`solve`/`step` over injected Geometry, so 0D, 2D (with phase fields,
anisotropy via the geometry), 3D volumes, ensembles, sharded meshes and
the adaptive-dt integrator all work unchanged.
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.models.base import Geometry, IonicModel, State

# Mitchell & Schaeffer 2003, Table 1 (the canonical parameter set)
TAU_IN = 0.3      # ms
TAU_OUT = 6.0     # ms
TAU_OPEN = 120.0  # ms
TAU_CLOSE = 150.0  # ms
U_GATE = 0.13     # dimensionless threshold


def apd_max_analytic() -> float:
    """Closed-form maximum APD (Mitchell & Schaeffer 2003 eqs. 11-13):
    the h excursion during one AP spans from 1 down to
    h_min = 4·τ_in/τ_out, and repolarization is h-limited, so
    APD_max = τ_close · ln(1/h_min)."""
    h_min = 4.0 * TAU_IN / TAU_OUT
    return TAU_CLOSE * float(np.log(1.0 / h_min))


class MitchellSchaeffer(IonicModel):
    name = "ms"
    # channel-block (drug) interface: the two phenomenological currents
    # (g_in = 1/tau_in inward, g_out = 1/tau_out outward)
    SCALE_PARAMS = ("g_in", "g_out")
    min_v = 0.0
    max_v = 1.0
    depol = 0.0
    dt_per_step = 10
    pot_key = "u"

    def state_keys(self):
        return ("h", "u")

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        """(u, h) = (0, 1): rested and fully recovered; S1 is a 5-column
        stripe (the model needs a super-threshold seed wider than
        fenton's 1-px stripe because τ_in regeneration is slower than
        the stripe's diffusive collapse at 1 px)."""
        u = self._full(0.0)
        if s1:
            u[:, :5] = 1.0
        return {"u": u, "h": self._full(1.0)}

    def solve(self, state: State, geom: Geometry) -> State:
        """One substep: explicit Euler on u (reaction + diffusion, the
        zoo's standard form), EXACT exponential relaxation on h (the
        gate ODE is piecewise-linear: dh/dt = (1−h)/τ_open below u_gate,
        −h/τ_close above — the Rush-Larsen step is exact here, not an
        approximation)."""
        u, h = state["u"], state["h"]
        dt = self.cfg.dt
        u0 = geom.enforce_boundary(u)

        j_in = self.gscale("g_in", h * u * u * (1.0 - u) / TAU_IN)
        j_out = self.gscale("g_out", -u / TAU_OUT)
        u1 = u0 + dt * (j_in + j_out) + self.cfg.diff * dt * geom.laplace(u0)

        open_ = u < U_GATE
        # exact one-substep solutions of the two linear branches
        h_open = 1.0 - (1.0 - h) * jnp.exp(-dt / TAU_OPEN)
        h_close = h * jnp.exp(-dt / TAU_CLOSE)
        h1 = jnp.where(open_, h_open, h_close)
        return {"u": u1, "h": h1}
