"""State checkpoint / resume.

The reference had three ad-hoc host-side mechanisms (SURVEY.md §5):
`run(keep_state=True)` harvesting variables to a dict (ionic.py:226-229),
`np.save`/`np.load` of that dict across processes (court_ultra.py:511-519),
and voltage-movie cubes.  Here the state is already a pytree of numpy
arrays, saved as one compressed .npz alongside a JSON config snapshot, with
optional orbax for large multi-host runs.  Reference-style pickled .npy
dict files load transparently.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from fib_tf_tpu.config import SimConfig


def save_state(
    path: str,
    state: Dict[str, np.ndarray],
    cfg: Optional[SimConfig] = None,
):
    """Save a state pytree (+ config snapshot) as .npz."""
    payload = {f"state/{k}": np.asarray(v) for k, v in state.items()}
    if cfg is not None:
        payload["config_json"] = np.frombuffer(
            json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8
        )
    np.savez_compressed(path, **payload)


def load_state(path: str) -> Tuple[Dict[str, np.ndarray], Optional[SimConfig]]:
    """Load a state pytree saved by `save_state`, or a reference-style
    pickled dict .npy (court_ultra.py:518-519)."""
    if path.endswith(".npy"):
        d = np.load(path, allow_pickle=True).item(0)
        return {k: np.asarray(v) for k, v in d.items()}, None

    with np.load(path) as z:
        state = {
            k[len("state/"):]: z[k] for k in z.files if k.startswith("state/")
        }
        cfg = None
        if "config_json" in z.files:
            raw = json.loads(bytes(z["config_json"].tobytes()).decode())
            # tuples don't survive JSON; restore the fields that need it
            if raw.get("mesh_shape") is not None:
                raw["mesh_shape"] = tuple(raw["mesh_shape"])
            raw["mesh_axes"] = tuple(raw.get("mesh_axes", ("x", "y")))
            # from_dict drops fields this version no longer has (e.g.
            # the retired kernel options), so old checkpoints still load
            cfg = SimConfig.from_dict(raw)
    return state, cfg


def save_state_orbax(path: str, state: Dict[str, np.ndarray]):
    """Orbax checkpoint (for sharded/multi-host states)."""
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    ckptr.save(os.path.abspath(path), state)


def load_state_orbax(path: str) -> Dict[str, np.ndarray]:
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    return ckptr.restore(os.path.abspath(path))
