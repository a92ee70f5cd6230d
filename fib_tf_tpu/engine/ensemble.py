"""Batched (ensemble) simulation — the data-parallel axis.

No reference equivalent (it ran one sheet per process); here an
ensemble of independent simulations — parameter sweeps, S2-timing scans,
initial-condition perturbations — is `vmap` over a leading member axis,
and sharding that axis over a mesh is embarrassingly-parallel data
parallelism (no halos cross ensemble members).

The scheduling primitive is `EnsembleEvent`: a stimulus fired at a
per-member step inside the compiled scan, so a whole S2-timing scan (the
vulnerable-window experiment the reference could only run serially, one
process per S2 time) is ONE device program.  See examples/s2_scan.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.models.base import Geometry, IonicModel, grid_geometry
from fib_tf_tpu.ops import stencil
from fib_tf_tpu.utils import cache


def stack_states(states) -> Dict[str, np.ndarray]:
    """List of state dicts -> one stacked pytree with leading ensemble
    axis."""
    keys = states[0].keys()
    return {k: np.stack([np.asarray(s[k]) for s in states]) for k in keys}


@dataclass
class EnsembleEvent:
    """A pacing stimulus fired inside the scan at a per-member step.

    `step` is a scalar (all members) or an [n_members] int array; `loc`
    is one of stencil.PACE_LOCATIONS, or pass an explicit `mask`
    ([H, W] shared or [n, H, W] per member, background model.min_v — the
    engine's add_pace_op convention, reference ionic.py:125-163).  The
    stimulus is pot <- max(pot, mask) on the member's potential plane at
    the END of outer step `step`, matching the run() generator's
    fire-at-yield timing (engine/simulation.py fire_op semantics).
    """

    step: Union[int, np.ndarray]
    loc: Optional[str] = None
    v: Optional[float] = None
    mask: Optional[np.ndarray] = None

    def resolve_mask(self, model: IonicModel) -> np.ndarray:
        if (self.loc is None) == (self.mask is None):
            raise ValueError("EnsembleEvent needs exactly one of loc/mask")
        if self.mask is not None:
            return np.asarray(self.mask, np.float32)
        v = model.max_v if self.v is None else self.v
        return stencil.pace_mask(
            model.cfg.height, model.cfg.width, self.loc, v, model.min_v
        )


def run_ensemble(
    model: IonicModel,
    stacked_state: Dict[str, np.ndarray],
    n_outer: int,
    phase: Optional[np.ndarray] = None,
    mesh=None,
    events: Sequence[EnsembleEvent] = (),
    probe: Optional[Callable] = None,
):
    """Advance every ensemble member `n_outer` outer steps.

    - `phase`: optional phase field, [H, W] shared or [n, H, W] per
      member (e.g. per-member obstacle geometry).
    - `events`: EnsembleEvents fired inside the scan (per-member steps).
    - `probe`: callable state -> scalar or dict of scalars sampled every
      outer step (default model.probe — the engine's probe stream
      convention); dict probes return dict-of-[n, n_outer] streams.

    Returns (final stacked state, probe streams [n, n_outer] or dict).
    With `mesh`, the member axis is sharded over the mesh's first axis
    and GSPMD partitions the vmapped scan.
    """
    cache.enable()
    probe = probe or model.probe
    n_members = next(iter(stacked_state.values())).shape[0]

    per_member_phase = phase is not None and np.asarray(phase).ndim == 3
    if phase is not None:
        phase = jnp.asarray(np.asarray(phase, np.float32))

    # a mesh shards the member axis, which needs an even split: pad the
    # batch to a shard multiple with copies of the last member (their
    # results are computed and discarded — HBM/FLOP cost only, no
    # semantic effect) and crop every output back to n_members below
    pad_n = 0
    if mesh is not None:
        pad_n = (-n_members) % mesh.devices.shape[0]

    def _pad_members(a):
        reps = (pad_n,) + (1,) * (np.asarray(a).ndim - 1)
        return np.concatenate([a, np.tile(np.asarray(a)[-1:], reps)])

    if pad_n:
        stacked_state = {k: _pad_members(v) for k, v in stacked_state.items()}
        if per_member_phase:
            phase = jnp.asarray(_pad_members(phase))

    ev_masks = [jnp.asarray(e.resolve_mask(model)) for e in events]
    if pad_n:
        ev_masks = [
            jnp.asarray(_pad_members(m)) if m.ndim == 3 else m
            for m in ev_masks
        ]
    ev_steps = [
        _pad_members(np.broadcast_to(np.asarray(e.step, np.int32),
                                     (n_members,)))
        for e in events
    ]
    ev_steps = [jnp.asarray(t) for t in ev_steps]
    pot_key = model.pot_key

    if per_member_phase:
        # grid_geometry precomputes the padded phase on the host, which a
        # vmap-traced per-member phase can't do — pad inside the op instead
        def member_geom(ph):
            return Geometry(
                laplace=lambda x: stencil.laplace(x, phase=ph),
                enforce_boundary=stencil.enforce_boundary,
            )

        vstep = jax.vmap(lambda s, ph: model.step(s, member_geom(ph)))
        step_members = lambda s: vstep(s, phase)  # noqa: E731
    else:
        geom = grid_geometry(phase)
        step_members = jax.vmap(lambda s: model.step(s, geom))
    vprobe = jax.vmap(probe)

    n_ev = len(ev_masks)

    def _transpose(p):
        return jnp.moveaxis(p, 0, 1)  # [n_outer, n] -> [n, n_outer]

    # events are explicit args (not closure constants) so the per-member
    # step/mask arrays shard with the batch
    def scan_chunk(s, *ev_args):
        steps, masks = ev_args[:n_ev], ev_args[n_ev:]

        def fire_events(state, i):
            pot = state[pot_key]
            for t, m in zip(steps, masks):
                hit = (i == t)[:, None, None]
                stim = jnp.maximum(pot, m if m.ndim == 3 else m[None])
                pot = jnp.where(hit, stim, pot)
            return {**state, pot_key: pot}

        def body(carry, _):
            s, i = carry
            s = step_members(s)
            if n_ev:
                s = fire_events(s, i)
            return (s, i + 1), vprobe(s)

        (final, _), probes = jax.lax.scan(
            body, (s, jnp.int32(0)), None, length=n_outer
        )
        return final, jax.tree.map(_transpose, probes)

    state = {k: jnp.asarray(v) for k, v in stacked_state.items()}
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P(mesh.axis_names[0]))
        state = {k: jax.device_put(v, sh) for k, v in state.items()}
    chunk = jax.jit(scan_chunk)
    final, probes = chunk(state, *ev_steps, *ev_masks)
    final = {k: np.asarray(v)[:n_members] for k, v in final.items()}
    if isinstance(probes, dict):
        return final, {k: np.asarray(v)[:n_members] for k, v in probes.items()}
    return final, np.asarray(probes)[:n_members]


def s2_scan(
    model: IonicModel,
    n_outer: int,
    s2_steps: np.ndarray,
    s2_loc: str = "luq",
    phase: Optional[np.ndarray] = None,
    mesh=None,
    activity_threshold: float = 0.1,
):
    """Vulnerable-window scan: one S1 wave (model.initial_state(s1=True)),
    then one S2 stimulus per member at `s2_steps[i]` (outer steps), run to
    `n_outer`.  Returns (s2_steps, sustained [n] bool, probes [n, n_outer]):
    a member counts as "sustained" (reentry induced) if any tissue is
    still active — normalized potential above `activity_threshold` — at
    the end, long after a plain S1 or a too-early/too-late S2 would have
    repolarized.
    """
    s2_steps = np.asarray(s2_steps, np.int32)
    n = len(s2_steps)
    stacked = stack_states([model.initial_state(s1=True)] * n)
    ev = EnsembleEvent(step=s2_steps, loc=s2_loc)
    final, probes = run_ensemble(
        model, stacked, n_outer, phase=phase, mesh=mesh, events=[ev],
    )
    img = (final[model.pot_key] - model.min_v) / (model.max_v - model.min_v)
    if phase is not None:
        ph = np.asarray(phase)
        img = img * (ph if ph.ndim == 3 else ph[None])
    sustained = (img > activity_threshold).any(axis=(1, 2))
    return s2_steps, np.asarray(sustained), probes
