"""The JAX package's dataset CLI on the CPU over the rendered TUM lane: the
reference the port's CLI lane (``chip_smoke.py`` phase ``cli_tum``) is
gated against.

    python scripts/jax_cli_reference.py [--frames 300] [--async] [--drop-stale]
                                        [--port-orb]

Writes the lane's TUM-RGBD-format sequence with the port's writer
(``snakeslam_tpu_torch/utils/tum_fixture.py``: seed 7, 2000 points, 300
frames of 640x480 at 30 Hz), copies ``configs/tum.ini`` into a temporary
directory (``Settings.from_ini`` writes missing keys back into the file it
reads), and runs ``snakeslam_tpu.__main__.main`` on it unmodified, on the
CPU.  ``--async`` sets ``async_mode`` and ``async_lba`` in the copy.
``--drop-stale`` gives ``finalize`` what the port's realign reads: each
tracked frame's matches whose point slot was freed and reallocated since
the frame was tracked are dropped before ``finalize`` runs (the port's
``SlamMap.live_matches``; the JAX package's realign keeps them).  The
package's files are not changed: the run wraps ``SlamSystem.process_frame``
and ``SlamSystem.finalize`` in this process.  ``--port-orb`` hands the
JAX package the port's ORB features (``snakeslam_tpu_torch``'s
``FeatureDetector`` on the CPU, which a CUDA device reproduces bit for
bit) in place of its own: the JAX package's tracking, mapping and
``finalize`` then start from exactly the features the port's CLI sees, the
reference the port's card run is gated on.  Without it the two packages'
features differ in the last bits (a resized pyramid level rounds in
another order), which is enough to move this lane's final keyframe count
and ATE.

Prints one JSON object: tracked frames, keyframes, map points, the SE3 ATE
of ``<prefix>_frames_ba.tum`` against ``groundtruth.txt`` (camera centres,
read back with the port's ``read_tum``), the run's wall time as the CLI
prints it, the whole call's seconds, the keyframe culls counted by the
frame they happened at and, with ``--drop-stale``, the matches dropped.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from snakeslam_tpu.__main__ import main as jax_main  # noqa: E402
from snakeslam_tpu.system.slam import SlamSystem  # noqa: E402
from snakeslam_tpu_torch.utils import tum_fixture as TF  # noqa: E402


def drop_stale_matches() -> dict:
    """Wraps the JAX ``SlamSystem`` so that ``finalize`` sees no match of a
    reused point slot: ``pt_alloc_gen`` of each match's slot is recorded
    when the frame is tracked, and matches whose slot has been reallocated
    since are set to -1 before ``finalize``.  Returns the dict that
    receives the count."""
    gens, stats = {}, {}
    process, finalize = SlamSystem.process_frame, SlamSystem.finalize

    def process_frame(self, frame):
        st = process(self, frame)
        if frame.matches is not None:
            gens[id(frame)] = self.map.pt_alloc_gen[
                np.maximum(frame.matches, 0)]
        return st

    def finalize_live(self, *a, **k):
        n = 0
        for f in self.tracker.trajectory:
            g = gens.get(id(f))
            if g is None or f.matches is None or f.is_keyframe:
                continue
            stale = (f.matches >= 0) & (
                self.map.pt_alloc_gen[np.maximum(f.matches, 0)] != g)
            n += int(stale.sum())
            f.matches = np.where(stale, -1, f.matches)
        stats["stale_matches_dropped"] = n
        return finalize(self, *a, **k)

    SlamSystem.process_frame = process_frame
    SlamSystem.finalize = finalize_live
    return stats


def use_port_orb() -> None:
    """Wraps the JAX ``FeatureDetector.detect`` to return the port's
    features of the same image, as the JAX package's ``FrameData``."""
    from snakeslam_tpu.frontend.feature_detector import FeatureDetector
    from snakeslam_tpu.map.slam_map import FrameData
    from snakeslam_tpu_torch.frontend.feature_detector import (
        FeatureDetector as PortDetector)

    def detect(self, image, frame_id, timestamp):
        if "_port" not in self.__dict__:
            self._port = PortDetector(self.s, device="cpu")
        f = self._port.detect(image, frame_id, timestamp)
        return FrameData(frame_id=f.frame_id, timestamp=f.timestamp,
                         uv=f.uv, octave=f.octave, angle=f.angle,
                         descriptors=f.descriptors, right=f.right,
                         depth=f.depth)

    FeatureDetector.detect = detect


def count_culls() -> dict:
    """Wraps the JAX keyframe culling to count its culls by the number of
    frames tracked before each (a cull while frame i is tracked counts at
    i; one in ``finalize`` at the run's length).  Returns the dict that
    receives the counts."""
    from snakeslam_tpu.optim.simplification import Simplification

    culls: dict = {}
    erase = Simplification._erase
    process = SlamSystem.process_frame

    def process_frame(self, frame):
        try:
            return process(self, frame)
        finally:
            culls["_frames"] = culls.get("_frames", 0) + 1

    def erase_counted(self, kf):
        at = str(culls.get("_frames", 0))
        culls[at] = culls.get(at, 0) + 1
        return erase(self, kf)

    SlamSystem.process_frame = process_frame
    Simplification._erase = erase_counted
    return culls


def parse_cli_output(text: str) -> dict:
    """Tracked frames, wall, keyframes and points from the CLI's lines."""
    m = re.search(r"tracked (\d+) frames in ([\d.]+)s", text)
    k = re.search(r"keyframes: (\d+)\s+points: (\d+)", text)
    return dict(tracked=int(m.group(1)), wall_s=float(m.group(2)),
                keyframes=int(k.group(1)), points=int(k.group(2)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--async", dest="async_", action="store_true")
    ap.add_argument("--drop-stale", action="store_true")
    ap.add_argument("--port-orb", action="store_true")
    args = ap.parse_args()
    dropped = drop_stale_matches() if args.drop_stale else {}
    if args.port_orb:
        use_port_orb()
    culls = count_culls()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        info = TF.write_tum_fixture(tmp / "tum", TF.lane_world(),
                                    TF.lane_trajectory(args.frames))
        write_s = time.perf_counter() - t0
        extra = dict(async_mode="true", async_lba="true") if args.async_ else {}
        ini = TF.copy_config(tmp / "tum.ini", **extra)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = jax_main([str(ini), "--dataset", str(tmp / "tum"),
                           "--outDir", str(tmp / "out")])
        call_s = time.perf_counter() - t0
        print(out.getvalue(), file=sys.stderr)
        res = parse_cli_output(out.getvalue())
        ate, n = TF.ate_against_groundtruth(
            tmp / "out" / "trajectory_frames_ba.tum",
            tmp / "tum" / "groundtruth.txt")
        print(json.dumps(dict(rc=rc, frames=info["frames"],
                              points_in_view=info["points_in_view"],
                              min_points_in_view=info["min_points_in_view"],
                              **res, ate_m=ate, ate_matched=n,
                              write_s=write_s, call_s=call_s,
                              async_mode=args.async_,
                              drop_stale=args.drop_stale,
                              port_orb=args.port_orb, **dropped,
                              culls_at_frame={k: v for k, v in culls.items()
                                              if k != "_frames"})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
