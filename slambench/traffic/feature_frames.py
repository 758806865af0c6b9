"""Generator ``feature_frames``: feature-level frames of a synthetic world
(``traffic/frames.py``) along a loop or an orbit arc, for the windowed
entry.  Each session sequence has a world of its own; the warm-up is a
sequence of its own with dense time stamps, or the first frames of a
session sequence."""

from __future__ import annotations

from traffic.frames import feature_frames
from traffic.sequence import Sequence, true_centres
from traffic.synthetic import SyntheticWorld, loop_trajectory, orbit_trajectory


def _trajectory(t: dict, n: int, arc_scale: float = 1.0):
    if t["trajectory"] == "loop":
        return loop_trajectory(n, radius=t["radius_m"], fps=t["fps"])
    return orbit_trajectory(n, radius=t["radius_m"],
                            arc=t["arc_rad"] * arc_scale, fps=t["fps"])


def sequences(cell, seeds: list[int], workdir):
    t = cell.traffic
    ini = cell.config["ini"]
    stereo = int(ini["Input"]["input_type"]) == 2
    rgbd = int(ini["Input"]["input_type"]) == 1

    def frames(world_seed, traj):
        world = SyntheticWorld(n_points=t["world_points"], seed=world_seed)
        return list(feature_frames(world, traj, stereo=stereo, rgbd=rgbd,
                                   noise_px=t["noise_px"]))

    seqs = []
    for s in seeds[:-1]:
        raw = frames(s, _trajectory(t, t["frames"]))
        seqs.append(Sequence(raw=raw, frames=t["frames"],
                             truth=true_centres(raw)))
    w = t["warmup"]
    if w["sequence"] == "own":
        # a sequence of its own whose dense time stamps make keyframes
        # often, so every program of the keyframe cycle is met
        raw = frames(seeds[-1], _trajectory(t, w["frames"],
                                            w["frames"] / t["frames"]))
        for r in raw:
            r.timestamp = r.frame_id / w["dense_fps"]
    else:
        raw = seqs[w["sequence"]].raw[:w["frames"]]
    return seqs, Sequence(raw=raw, frames=len(raw))
