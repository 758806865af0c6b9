"""Generator ``tum_render``: a room-sized world rendered along an inward
orbit arc into TUM RGB-D's layout under ``workdir`` (``traffic/tum.py``),
for the per-frame entry, which reads it as the CLI reads a dataset.  The
warm-up reads the first frames of a session sequence."""

from __future__ import annotations

from traffic.sequence import Sequence
from traffic.tum import arc_trajectory, room_world, write_sequence


def sequences(cell, seeds: list[int], workdir):
    t = cell.traffic
    seqs = []
    for i, s in enumerate(seeds[:-1]):
        world = room_world(cell.config["camera"], s, t["world_points"],
                           t["extent_m"])
        traj = arc_trajectory(t["frames"], t["fps"], t["radius_m"],
                              t["arc_rad"])
        root = workdir / f"seq{i}"
        images = [str(root / n) for n in write_sequence(root, world, traj)]
        seqs.append(Sequence(root=root, images=images, frames=t["frames"]))
    w = t["warmup"]
    base = seqs[w["sequence"]]
    return seqs, Sequence(root=base.root, images=base.images,
                          frames=w["frames"])
