"""S1-S2 APD restitution as ONE batched ensemble program.

The restitution curve — action-potential duration vs the preceding
diastolic interval (DI) — is the standard dynamic characterization of a
cardiac model (steep slope > 1 predicts alternans/breakup).  The
reference had no restitution tooling; measuring a curve meant one
process per S2 coupling interval, like its serial vulnerable-window
scans.  Here every coupling interval is an ensemble member: an S1 pacing
train is fired at shared steps, the S2 at a per-member step
(`EnsembleEvent`), and the whole protocol is a single compiled scan
(engine/ensemble.py).

APD/DI extraction is host-side post-processing of the per-member probe
streams, reusing the APD-at-level convention of the published-physiology
pins (tests/test_physiology.py::apd90).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from fib_tf_tpu.engine.ensemble import (
    EnsembleEvent, run_ensemble, stack_states,
)
from fib_tf_tpu.models.base import IonicModel

# suprathreshold uniform-stimulus level per model family: the potential
# plane is lifted to max(pot, v) everywhere, so diastolic tissue fires
# while refractory tissue (already above v) is unaffected — the pacing
# semantics of reference ionic.py:144-163 applied full-field
STIM_V = {"fenton": 1.0, "br": 0.0, "court": 0.0, "court_ultra": 0.0,
          "ms": 1.0, "lr1": 0.0, "tp06": 0.0}


def apd_at_level(
    trace: np.ndarray,
    rest: float,
    dt_ms: float,
    start: int = 0,
    level: float = 0.9,
) -> Tuple[float, float]:
    """APD at `level` repolarization for the first AP in trace[start:].

    Returns (t_up_ms, apd_ms) with t_up measured from trace[0]; both NaN
    if no AP is found (no crossing, or no repolarization in the window).
    The threshold convention matches tests/test_physiology.py::apd90:
    peak - level*(peak - rest), upstroke = first up-crossing, end = first
    down-crossing after the peak.
    """
    tr = trace[start:]
    peak = tr.max()
    if peak <= rest:
        return float("nan"), float("nan")
    thr = peak - level * (peak - rest)
    i_up = int(np.argmax(tr >= thr))
    i_peak = i_up + int(tr[i_up:].argmax())
    below = np.where(tr[i_peak:] < thr)[0]
    if not len(below):
        return float((start + i_up) * dt_ms), float("nan")
    return (
        float((start + i_up) * dt_ms),
        float((i_peak + below[0] - i_up) * dt_ms),
    )


@dataclass
class RestitutionResult:
    coupling_ms: np.ndarray  # [n] S2 coupling interval (last S1 -> S2)
    di_ms: np.ndarray        # [n] diastolic interval preceding the S2 AP
    apd_ms: np.ndarray       # [n] APD of the S2 response (NaN = no capture)
    apd_s1_ms: float         # APD of the last S1 beat (shared pre-S2)
    captured: np.ndarray     # [n] bool, S2 elicited an AP that repolarized
    traces: np.ndarray       # [n, n_outer] probe-pixel potential
    dt_ms: float             # ms per trace sample (= outer step)

    def slope(self) -> Optional[float]:
        """Max restitution slope dAPD/dDI over captured points (finite
        differences on the DI-sorted curve); None if < 2 points."""
        return _max_slope(self.di_ms, self.apd_ms, self.captured)


def _snap_to_steps(values_ms: np.ndarray, dt_ms: float,
                   name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Snap interval values to the outer-step grid, warning once if any
    moved.  Returns (snapped_ms, steps); shared by all three protocols
    so the tolerance/warning stays in one place."""
    import warnings

    values_ms = np.atleast_1d(np.asarray(values_ms, np.float64))
    steps = np.asarray(np.round(values_ms / dt_ms), np.int32)
    snapped = steps * dt_ms
    if not np.allclose(snapped, values_ms):
        warnings.warn(
            f"{name} snapped to the {dt_ms} ms outer-step interval"
        )
    return snapped, steps


def _max_slope(di_ms: np.ndarray, apd_ms: np.ndarray,
               captured: np.ndarray) -> Optional[float]:
    """Max dAPD/dDI by finite differences on the DI-sorted captured
    points; None if fewer than two usable points."""
    m = captured & np.isfinite(apd_ms) & np.isfinite(di_ms)
    if m.sum() < 2:
        return None
    order = np.argsort(di_ms[m])
    di, apd = di_ms[m][order], apd_ms[m][order]
    d_di = np.diff(di)
    ok = d_di > 0
    if not ok.any():
        return None
    return float((np.diff(apd)[ok] / d_di[ok]).max())


@dataclass
class DynamicRestitutionResult:
    bcl_ms: np.ndarray        # [n] pacing basic cycle length per member
    apd_ms: np.ndarray        # [n] final-beat APD (NaN = capture failure)
    apd_prev_ms: np.ndarray   # [n] penultimate-beat APD
    di_ms: np.ndarray         # [n] DI preceding the final beat
    alternans_ms: np.ndarray  # [n] |APD_last - APD_prev| (beat-to-beat)
    captured: np.ndarray      # [n] both of the last two beats captured 1:1
    traces: np.ndarray        # [n, n_outer] probe-pixel potential
    dt_ms: float              # ms per trace sample (= outer step)
    n_beats: int              # pacing-train length

    def slope(self) -> Optional[float]:
        """Max dynamic-restitution slope dAPD/dDI over 1:1-captured
        members."""
        return _max_slope(self.di_ms, self.apd_ms, self.captured)


def dynamic_restitution_scan(
    model: IonicModel,
    bcl_ms: np.ndarray,
    n_beats: int = 8,
    tail_ms: float = 500.0,
    stim_v: Optional[float] = None,
    pixel: Optional[Tuple[int, int]] = None,
    level: float = 0.9,
    min_apd_ms: float = 20.0,
    mesh=None,
) -> DynamicRestitutionResult:
    """Dynamic (steady-state-pacing) restitution: one PACING RATE per
    ensemble member.

    The S1-S2 protocol (restitution_scan) probes the response to a
    single premature beat from one adapted state; the dynamic protocol —
    the one alternans analyses are built on (ten Tusscher & Panfilov
    2006 use both) — paces each member at a fixed basic cycle length
    `bcl_ms[i]` for `n_beats` beats and reads the last two APDs.  A
    steep dynamic curve (slope > 1) predicts APD alternans, and the
    per-member beat-to-beat difference `alternans_ms` measures it
    directly; members driven past their refractory limit drop beats
    (2:1 block), which the capture test reports as captured=False.

    All rates run as ONE compiled scan: beat k of member i fires at the
    per-member step `pre + k*round(bcl_i/dt)` via EnsembleEvent's
    per-member step arrays.  `bcl_ms` values are snapped to the
    outer-step interval with a warning, like restitution_scan's
    couplings.  Uniform suprathreshold stimulation on a small sheet is
    the cell-level setup — use 4x4..16x16 grids.
    """
    cfg = model.cfg
    dt_ms = model.dt_per_step * cfg.dt
    if stim_v is None:
        stim_v = STIM_V.get(model.name, model.max_v)
    if n_beats < 2:
        raise ValueError("dynamic restitution needs n_beats >= 2 "
                         "(the curve reads the last TWO beats)")
    bcl_ms, bcl_steps = _snap_to_steps(bcl_ms, dt_ms, "bcl_ms")
    n = len(bcl_ms)

    h, w = cfg.height, cfg.width
    stim_mask = np.full((h, w), stim_v, np.float32)
    pre = max(int(round(10.0 / dt_ms)), 1)
    beat_steps = pre + bcl_steps[None, :] * np.arange(
        n_beats, dtype=np.int32)[:, None]          # [n_beats, n]
    n_outer = int(beat_steps.max()) + int(round(tail_ms / dt_ms)) + 1
    events = [
        EnsembleEvent(step=beat_steps[k].astype(np.int32), mask=stim_mask)
        for k in range(n_beats)
    ]

    if pixel is None:
        pixel = (h // 2, w // 2)
    py, px = pixel
    pot_key = model.pot_key

    stacked = stack_states([model.initial_state(s1=False)] * n)
    _, traces = run_ensemble(
        model, stacked, int(n_outer),
        events=events,
        probe=lambda s: s[pot_key][py, px],
        mesh=mesh,
    )
    traces = np.asarray(traces)

    apd = np.full(n, np.nan)
    apd_prev = np.full(n, np.nan)
    di = np.full(n, np.nan)
    alternans = np.full(n, np.nan)
    captured = np.zeros(n, bool)
    for i in range(n):
        rest = float(traces[i][pre - 1])

        def beat(k):
            """(t_up_ms, apd_ms, captured) for beat k of member i.  The
            search window is BOUNDED at the next stimulus so a later
            beat with a higher peak can never capture this beat's
            peak/repolarization search (two-beat-spanning APDs were the
            failure mode for odd n_beats before this bound)."""
            s = int(beat_steps[k, i])
            end = (int(beat_steps[k + 1, i]) if k + 1 < n_beats
                   else traces.shape[1])
            tr = traces[i][:end]
            t_up, a = apd_at_level(tr, rest, dt_ms, start=s, level=level)
            if not np.isfinite(a):
                return t_up, a, False
            win = tr[s:]
            thr = win.max() - level * (win.max() - rest)
            pre_ok = s == 0 or traces[i][s - 1] < thr
            ok = (t_up <= s * dt_ms + 2 * dt_ms and pre_ok
                  and a >= min_apd_ms)
            return t_up, a, ok

        t_up_p, a_p, ok_p = beat(n_beats - 2)
        t_up_l, a_l, ok_l = beat(n_beats - 1)
        apd_prev[i], apd[i] = a_p, a_l
        if ok_p and ok_l:
            captured[i] = True
            di[i] = beat_steps[n_beats - 1, i] * dt_ms - (t_up_p + a_p)
            alternans[i] = abs(a_l - a_p)
        else:
            apd[i] = np.nan
    return DynamicRestitutionResult(
        bcl_ms=bcl_ms, apd_ms=apd, apd_prev_ms=apd_prev, di_ms=di,
        alternans_ms=alternans, captured=captured, traces=traces,
        dt_ms=dt_ms, n_beats=n_beats,
    )


def _cross_time(tr: np.ndarray, thr: float, dt_ms: float,
                start: int = 0) -> float:
    """Time (ms, from trace[0]) of the first RISING crossing of `thr`
    in trace[start:] (previous sample below, current at/above — a
    genuine wavefront arrival, not an already-depolarized plateau),
    linearly interpolated between samples; NaN if none."""
    w = tr[start:]
    above = w >= thr
    rising = above[1:] & ~above[:-1]
    if not rising.any():
        return float("nan")
    i = int(np.argmax(rising)) + 1
    v0, v1 = w[i - 1], w[i]
    frac = 0.0 if v1 == v0 else float((thr - v0) / (v1 - v0))
    return float((start + i - 1 + frac) * dt_ms)


@dataclass
class CVRestitutionResult:
    coupling_ms: np.ndarray  # [n] S2 coupling interval (last S1 -> S2)
    di_ms: np.ndarray        # [n] diastolic interval at the near site
    cv: np.ndarray           # [n] S2 conduction velocity (cells/ms)
    cv_s1: float             # S1 conduction velocity (cells/ms)
    captured: np.ndarray     # [n] S2 propagated across both sites
    traces: np.ndarray       # [n, n_outer, 2] potential at the two sites
    dt_ms: float


def cv_restitution_scan(
    model: IonicModel,
    coupling_ms: np.ndarray,
    bcl_ms: float = 400.0,
    n_s1: int = 1,
    tail_ms: float = 300.0,
    stim_v: Optional[float] = None,
    stim_cols: int = 4,
    sites: Optional[Tuple[int, int]] = None,
    level: float = 0.9,
    mesh=None,
) -> CVRestitutionResult:
    """Conduction-velocity restitution: CV of a premature (S2) wave vs
    the diastolic interval it propagates into.

    CV restitution is the second half of the wavebreak story: alternans
    needs a steep APD curve, but conduction BLOCK — the actual break —
    happens where a premature wavefront meets tissue whose DI is inside
    the CV curve's steep collapse.  The reference's CV machinery
    (diff_conduction_velcoty.dat) is a static dt/diff calibration; this
    measures the dynamic curve, one S2 coupling per ensemble member.

    Unlike the APD protocols (uniform field stimulation, no
    propagation), each member here is a genuine conducting strip: S1
    (and the per-member S2) are `stim_cols`-wide column stimuli at the
    left edge, and upstroke arrival is read at two sites `sites =
    (xA, xB)` on the mid row (defaults W/3 and 2W/3).  CV = (xB - xA) /
    (t_B - t_A) in cells/ms, with sub-sample linear interpolation of
    the threshold crossing; DI at the near site = S2 arrival minus the
    end of the local S1 APD (apd_at_level).  Members whose S2 falls
    into refractory tissue fail to reach both sites -> captured=False
    (the conduction-block edge of the curve).  Use a short strip
    (8 x 128..256); `coupling_ms` snaps to the outer-step interval.
    """
    cfg = model.cfg
    dt_ms = model.dt_per_step * cfg.dt
    if stim_v is None:
        stim_v = STIM_V.get(model.name, model.max_v)
    coupling_ms, coupling_steps = _snap_to_steps(coupling_ms, dt_ms,
                                                 "coupling_ms")
    n = len(coupling_ms)

    def to_steps(t_ms):
        return np.asarray(np.round(np.asarray(t_ms) / dt_ms), np.int32)

    h, w = cfg.height, cfg.width
    if sites is None:
        sites = (w // 3, 2 * w // 3)
    x_a, x_b = sites
    if not (stim_cols < x_a < x_b < w):
        raise ValueError(f"sites {sites} must satisfy "
                         f"stim_cols < xA < xB < width ({w})")
    mask = np.full((h, w), model.min_v, np.float32)
    mask[:, :stim_cols] = stim_v

    pre = max(int(round(10.0 / dt_ms)), 1)
    s1_steps = pre + to_steps(bcl_ms) * np.arange(n_s1, dtype=np.int32)
    last_s1 = int(s1_steps[-1])
    s2_steps = last_s1 + coupling_steps
    n_outer = int(s2_steps.max()) + to_steps(tail_ms) + 1

    events = [
        EnsembleEvent(step=int(s), mask=mask) for s in s1_steps
    ] + [EnsembleEvent(step=s2_steps.astype(np.int32), mask=mask)]

    y = h // 2
    pot_key = model.pot_key
    stacked = stack_states([model.initial_state(s1=False)] * n)
    import jax.numpy as jnp
    _, traces = run_ensemble(
        model, stacked, int(n_outer),
        events=events,
        probe=lambda s: jnp.stack([s[pot_key][y, x_a],
                                   s[pot_key][y, x_b]]),
        mesh=mesh,
    )
    traces = np.asarray(traces)  # [n, n_outer, 2]

    di = np.full(n, np.nan)
    cv = np.full(n, np.nan)
    captured = np.zeros(n, bool)
    cv_s1 = float("nan")
    dist = float(x_b - x_a)
    # S1 CV from the LONGEST-coupling member: its pre-S2 window is the
    # most likely to hold the whole S1 passage (member 0 alone would
    # make cv_s1 NaN whenever coupling_ms[0] is shorter than the S1
    # transit to site B)
    i_ref = int(np.argmax(s2_steps))
    for i in range(n):
        tr_a, tr_b = traces[i, :, 0], traces[i, :, 1]
        rest = float(tr_a[pre - 1])
        s2 = int(s2_steps[i])
        if s2 <= last_s1 + 1:
            continue  # coupling snapped to <= one step: not a premature
        # thresholds from the S1 beat's local amplitude (mid-level)
        pk_a = float(tr_a[last_s1:s2].max())
        pk_b = float(tr_b[last_s1:s2].max())
        if not (pk_a > rest and pk_b > rest):
            continue  # the S1 never reached a site: nothing to measure
        thr_a = rest + 0.5 * (pk_a - rest)
        thr_b = rest + 0.5 * (pk_b - rest)
        if i == i_ref:
            ta1 = _cross_time(tr_a, thr_a, dt_ms, start=last_s1)
            tb1 = _cross_time(tr_b, thr_b, dt_ms, start=last_s1)
            if np.isfinite(ta1) and np.isfinite(tb1) and tb1 > ta1:
                cv_s1 = dist / (tb1 - ta1)
        # S1 APD end at the near site, measured in the PRE-S2 window so
        # the S2 beat cannot capture the peak/repolarization search
        t_up_a1, apd_a = apd_at_level(tr_a[:s2], rest, dt_ms,
                                      start=last_s1, level=level)
        # S2 arrivals
        ta2 = _cross_time(tr_a, thr_a, dt_ms, start=s2)
        tb2 = _cross_time(tr_b, thr_b, dt_ms, start=s2)
        if not (np.isfinite(ta2) and np.isfinite(tb2)) or tb2 <= ta2:
            continue  # block before/between the sites: no capture
        captured[i] = True
        cv[i] = dist / (tb2 - ta2)
        if np.isfinite(apd_a) and np.isfinite(t_up_a1):
            di[i] = ta2 - (t_up_a1 + apd_a)
    return CVRestitutionResult(
        coupling_ms=coupling_ms, di_ms=di, cv=cv, cv_s1=cv_s1,
        captured=captured, traces=traces, dt_ms=dt_ms,
    )


def restitution_scan(
    model: IonicModel,
    coupling_ms: np.ndarray,
    bcl_ms: float = 400.0,
    n_s1: int = 2,
    tail_ms: float = 400.0,
    stim_v: Optional[float] = None,
    pixel: Optional[Tuple[int, int]] = None,
    level: float = 0.9,
    min_apd_ms: float = 20.0,
    mesh=None,
) -> RestitutionResult:
    """Run the S1-S2 restitution protocol, one member per S2 coupling.

    Protocol: from quiescent tissue, `n_s1` uniform suprathreshold
    stimuli at basic cycle length `bcl_ms`, then one S2 per member at
    `coupling_ms[i]` after the last S1, then `tail_ms` to let the S2
    response repolarize.  Uniform stimulation makes a small sheet behave
    as a single cell (no propagation), which is the standard cell-level
    restitution setup — use a 4x4..16x16 grid for speed.

    `coupling_ms` values must be multiples of the outer-step interval
    (model.dt_per_step * cfg.dt ms); they are snapped with a warning
    otherwise.  Returns a RestitutionResult; members whose S2 falls in
    the refractory period simply fail to capture (NaN APD), tracing the
    refractory edge of the curve.
    """
    cfg = model.cfg
    dt_ms = model.dt_per_step * cfg.dt
    if stim_v is None:
        stim_v = STIM_V.get(model.name, model.max_v)
    coupling_ms, coupling_steps = _snap_to_steps(coupling_ms, dt_ms,
                                                 "coupling_ms")
    n = len(coupling_ms)

    def to_steps(t_ms):
        return np.asarray(np.round(np.asarray(t_ms) / dt_ms), np.int32)

    h, w = cfg.height, cfg.width
    stim_mask = np.full((h, w), stim_v, np.float32)
    # a short pre-stim baseline so rest is read off each member's trace
    pre = max(int(round(10.0 / dt_ms)), 1)
    s1_steps = pre + to_steps(bcl_ms) * np.arange(n_s1, dtype=np.int32)
    last_s1 = int(s1_steps[-1])
    s2_steps = last_s1 + coupling_steps
    n_outer = int(s2_steps.max()) + to_steps(tail_ms) + 1

    # one extra CONTROL member whose S2 never fires: its trace gives the
    # uncontaminated last-S1 APD (a short coupling would otherwise
    # truncate the S1 beat on every scan member)
    all_s2 = np.concatenate([s2_steps, [n_outer + 1]]).astype(np.int32)
    events = [
        EnsembleEvent(step=int(s), mask=stim_mask) for s in s1_steps
    ] + [EnsembleEvent(step=all_s2, mask=stim_mask)]

    if pixel is None:
        pixel = (h // 2, w // 2)
    py, px = pixel
    pot_key = model.pot_key

    stacked = stack_states([model.initial_state(s1=False)] * (n + 1))
    _, traces = run_ensemble(
        model, stacked, int(n_outer),
        events=events,
        probe=lambda s: s[pot_key][py, px],
        mesh=mesh,
    )
    traces, control = np.asarray(traces[:n]), np.asarray(traces[n])

    # host-side curve extraction, per member
    di = np.full(n, np.nan)
    apd = np.full(n, np.nan)
    captured = np.zeros(n, bool)
    rest = float(control[pre - 1]) if pre > 0 else float(model.min_v)
    t_up_s1, apd_s1 = apd_at_level(
        control, rest, dt_ms, start=last_s1, level=level
    )
    for i in range(n):
        s2 = int(s2_steps[i])
        t_up, a = apd_at_level(traces[i], rest, dt_ms, start=s2, level=level)
        if not np.isfinite(a):
            continue
        # genuine capture: upstroke AT the S2 (not a later beat), tissue
        # sub-threshold just before the stimulus (otherwise the "AP" is
        # the last S1's plateau tail), and a real AP duration (a failed
        # stimulus decays in a few ms)
        win = traces[i][s2:]
        thr = win.max() - level * (win.max() - rest)
        pre_ok = s2 == 0 or traces[i][s2 - 1] < thr
        if t_up <= s2 * dt_ms + 2 * dt_ms and pre_ok and a >= min_apd_ms:
            apd[i] = a
            captured[i] = True
            if np.isfinite(apd_s1):
                di[i] = s2 * dt_ms - (t_up_s1 + apd_s1)
    return RestitutionResult(
        coupling_ms=coupling_ms, di_ms=di, apd_ms=apd,
        apd_s1_ms=apd_s1, captured=captured, traces=traces, dt_ms=dt_ms,
    )
