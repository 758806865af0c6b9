"""The reference ORB gives the program's features exactly on rendered
TUM frames, and its bfloat16 control does not."""

import json

import numpy as np
import torch

from harness import HERE
from reference import orb as ORB
from traffic.tum import arc_trajectory, room_world, write_sequence


def test_reference_orb_is_the_programs(tmp_path):
    from PIL import Image

    from snakeslam_tpu_torch.frontend.feature_detector import FeatureDetector
    from snakeslam_tpu_torch.system.settings import Settings

    cfg = json.loads((HERE / "configs" / "tum_rgbd_fr1.json").read_text())
    fd = cfg["ini"]["FeatureDetector"]
    world = room_world(cfg["camera"], 2_718_281_828, 2000, 2.5)
    names = write_sequence(tmp_path, world, arc_trajectory(3, 30.0, 3.5,
                                                           0.006))
    s = Settings()
    s.fd_features, s.fd_levels = fd["fd_features"], fd["fd_levels"]
    s.fd_scale_factor, s.fd_ini_th_fast = (fd["fd_scale_factor"],
                                           fd["fd_ini_th_fast"])
    det = FeatureDetector(s, device="cpu")
    for i, name in enumerate(names):
        img = np.asarray(Image.open(tmp_path / name), dtype=np.float32)
        f = det.detect(img, i, 0.0)
        prog = (f.uv, f.octave, f.angle, f.descriptors)
        args = (img, fd["fd_features"], fd["fd_levels"],
                fd["fd_scale_factor"], float(fd["fd_ini_th_fast"]))
        assert ORB.mismatch_pct(ORB.extract(*args), prog) == 0.0
        assert ORB.mismatch_pct(ORB.extract(*args, torch.bfloat16),
                                prog) > 50.0
