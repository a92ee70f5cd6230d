#!/usr/bin/env python
"""Fenton 4v scroll-wave experiment — 3D, beyond reference parity.

The 3D generalization of the reference's canonical S1-S2 spiral protocol
(fenton.py:155-187): a planar S1 wave crosses a [depth, H, W] slab; a
cross-field S2 over only the LOWER HALF of the depth (VolumeEvent z1)
creates a scroll wave whose filament ends inside the tissue — geometry a
2D framework cannot represent.  The run reports activity over time and
the per-slice rotor census of the final state (the mid-depth slice spins
while z-slices above the filament end do not), and saves the frame stack
for replay with examples/playcube.py (mid-depth slice movie).

The time step respects the 3D explicit stability limit
2/((8 + 8*dz_ratio)*diff) — TIGHTER than the 2D limit; see
engine/volume.run_volume's docstring.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))


import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine.volume import VolumeEvent, run_volume
from fib_tf_tpu.models import Fenton4v


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--s2-ms", type=float, default=250.0)
    ap.add_argument("--dz-ratio", type=float, default=1.0)
    ap.add_argument("--fiber-twist", type=float, default=0.0,
                    help="total transmural fiber rotation in degrees "
                         "(e.g. 120, the human LV wall; Fenton & Karma "
                         "1998 rotational anisotropy)")
    ap.add_argument("--fiber-ratio", type=float, default=1.0,
                    help="cross-fiber conduction fraction (enable the "
                         "twist by setting < 1, e.g. 0.25)")
    ap.add_argument("--save-cube", default=None,
                    help="save the mid-depth slice movie (npy) for "
                         "examples/playcube.py")
    ap.add_argument("--save-volume", default=None,
                    help="save the full [T, D, H, W] movie (npy) for "
                         "`python -m fib_tf_tpu filaments`")
    args = ap.parse_args()

    n = args.size
    dt = 0.05  # isotropic 3D limit at diff=1.5 is 2/(16*1.5) = 0.083
    cfg = SimConfig(width=n, height=n, dt=dt, diff=1.5,
                    duration=args.duration)
    model = Fenton4v(cfg)
    n_outer = int(args.duration / (model.dt_per_step * dt))
    s2_step = int(args.s2_ms / (model.dt_per_step * dt))

    final, probes, frames = run_volume(
        model, depth=args.depth, n_outer=n_outer,
        dz_ratio=args.dz_ratio,
        fiber_twist=np.deg2rad(args.fiber_twist),
        fiber_ratio=args.fiber_ratio,
        events=[VolumeEvent(step=s2_step, loc="luq", z1=args.depth // 2)],
        frames_every=max(1, n_outer // 30),
    )

    act = [(f > 0.1).mean() for f in frames]
    print("activity fraction over time:",
          " ".join(f"{a:.2f}" for a in act))

    # filament census over the movie (utils/filaments.py): the 3D rotor
    # count — a stable scroll is one filament; breakup multiplies them.
    # NOTE a genuine rotating core needs an in-plane domain comparable
    # to the model wavelength (~hundreds of cells for fenton): at toy
    # sizes the S2 only re-excites globally and the census reads 0.
    from fib_tf_tpu.utils.filaments import census_movie

    per_t = census_movie(frames, tau=2)
    counts = [len(fs) for fs in per_t]
    print("filaments/frame:", " ".join(str(c) for c in counts))
    if max(counts, default=0) > 0:
        peak = int(np.argmax(counts))
        for f in per_t[peak][:8]:
            z0, z1 = int(f.points[0, 0]), int(f.points[-1, 0])
            print(f"  frame {peak + 2}: charge {f.charge:+d}, "
                  f"z {z0}-{z1}, arc {f.arc_length:.1f} cells")

    if args.save_cube:
        mid = np.stack([f[args.depth // 2] for f in frames])
        np.save(args.save_cube, mid)
        print("saved mid-depth movie:", args.save_cube, mid.shape)
    if args.save_volume:
        np.save(args.save_volume, frames)
        print("saved volume movie:", args.save_volume, frames.shape)


if __name__ == "__main__":
    main()
