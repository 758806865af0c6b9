"""The frozen generators reproduce the program's current ones on a seed."""

import numpy as np

from traffic.frames import feature_frames
from traffic.render import _patches, render_frame
from traffic.synthetic import SyntheticWorld, loop_trajectory, orbit_trajectory


def test_world_and_feature_frames_equal_the_programs():
    from snakeslam_tpu_torch.frontend.synthetic_source import (
        apply_world_to_settings, synthetic_frames)
    from snakeslam_tpu_torch.system.settings import InputType, Settings
    from snakeslam_tpu_torch.utils import synthetic as PS

    for traj, n_pts in ((lambda m: m.loop_trajectory(12, radius=7.0,
                                                     fps=200.0), 5000),
                        (lambda m: m.orbit_trajectory(12, radius=7.0,
                                                      arc=1.2, fps=200.0),
                         3000)):
        seed = 3_000_000_017
        mine = SyntheticWorld(n_points=n_pts, seed=seed)
        theirs = PS.SyntheticWorld(n_points=n_pts, seed=seed)
        assert np.array_equal(mine.points, theirs.points)
        assert np.array_equal(mine.descriptors, theirs.descriptors)
        s = Settings()
        s.input_type = InputType.Stereo
        apply_world_to_settings(theirs, s)
        a = list(feature_frames(
            mine, traj(__import__("traffic.synthetic",
                                  fromlist=["x"])), stereo=True))
        b = list(synthetic_frames(theirs, traj(PS), s, noise_px=0.3))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for k in ("uv", "octave", "angle", "descriptors", "right",
                      "depth"):
                assert np.array_equal(getattr(x, k), getattr(y, k)), k
            assert x.timestamp == y.timestamp
            assert np.array_equal(x.gt_pose_cw, y.gt_pose_cw)


def test_trajectories_equal_the_programs():
    from snakeslam_tpu_torch.utils import synthetic as PS

    for a, b in ((loop_trajectory(9, radius=7.0), PS.loop_trajectory(
            9, radius=7.0)), (orbit_trajectory(9, arc=0.9), PS.orbit_trajectory(
            9, arc=0.9))):
        for (ta, Ta), (tb, Tb) in zip(a, b):
            assert ta == tb and np.array_equal(Ta, Tb)


def test_render_and_tum_writer_equal_the_programs(tmp_path):
    import json

    from snakeslam_tpu_torch.utils import render_world as PR
    from snakeslam_tpu_torch.utils import tum_fixture as TF
    from traffic.tum import arc_trajectory, room_world, write_sequence

    cam = json.loads((__import__("harness").HERE / "configs"
                      / "tum_rgbd_fr1.json").read_text())["camera"]
    world = room_world(cam, 7, 2000, 2.5)
    theirs = TF.lane_world(seed=7)
    assert np.array_equal(world.points, theirs.points)
    assert np.array_equal(_patches(2000, 7), PR._patches(2000, 7))
    traj = arc_trajectory(4, 30.0, 3.5, 0.9 * 3 / 299)
    ref = TF.lane_trajectory(4)
    for (ta, Ta), (tb, Tb) in zip(traj, ref):
        assert ta == tb and np.array_equal(Ta, Tb)
    img, z = render_frame(world, traj[1][1], 0.0, with_depth=True)
    img2, z2 = PR.render_frame(theirs, ref[1][1], 0.0, with_depth=True)
    assert np.array_equal(img, img2) and np.array_equal(z, z2)
    write_sequence(tmp_path / "a", world, traj)
    TF.write_tum_fixture(tmp_path / "b", theirs, ref)
    for f in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        assert ((tmp_path / "a" / f).read_text()
                == (tmp_path / "b" / f).read_text()), f
    for f in sorted((tmp_path / "b" / "rgb").iterdir()):
        for kind in ("rgb", "depth"):
            assert ((tmp_path / "a" / kind / f.name).read_bytes()
                    == (tmp_path / "b" / kind / f.name).read_bytes())
