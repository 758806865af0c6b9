"""The port's dataset CLI against the JAX package's.

Both packages' ``main()`` run once each (module-scoped) on the same small
TUM-RGBD-format sequence from ``utils/tum_fixture.py`` (320x240, every
fourth frame of the lane's first 64, so 16 frames at four times its
motion), with ``configs/tum.ini`` copied into the test's directory and cut
to 500 features on 2 levels: tracked frames equal, keyframes within one,
SE3 ATE of ``<prefix>_frames_ba.tum`` against the ground truth within 20%
of the JAX run's, the same output files.  The port's CLI refuses to start
without a CUDA device unless ``--device cpu`` is given.  (The JAX run is
most of this file's time: ~50 s on the CPU, mostly its compiles.)
"""

import contextlib
import io
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from snakeslam_tpu.__main__ import main as jax_main
from snakeslam_tpu_torch.__main__ import main as port_main
from snakeslam_tpu_torch.utils import tum_fixture as TF

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(fd_features=500, fd_levels=2, width=320, height=240,
             fx=TF.FR1["fx"] / 2, fy=TF.FR1["fy"] / 2, cx=TF.FR1["cx"] / 2,
             cy=TF.FR1["cy"] / 2, max_keyframes=256, max_points=32768,
             feature_slots=512, local_map_slots=2048, lba_cam_slots=16,
             lba_point_slots=2048, lba_obs_slots=8)




def _summary(text: str, out: Path, data: Path) -> dict:
    tracked = int(re.search(r"tracked (\d+) frames", text).group(1))
    k = re.search(r"keyframes: (\d+)\s+points: (\d+)", text)
    ate, n = TF.ate_against_groundtruth(out / "trajectory_frames_ba.tum",
                                        data / "groundtruth.txt")
    return dict(tracked=tracked, keyframes=int(k.group(1)),
                points=int(k.group(2)), ate=ate, matched=n,
                files=sorted(p.name for p in out.iterdir()))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the test workers share the machine's cores,
    and oversubscribed thread pools spin on the runs' small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = root / "tum"
    TF.write_tum_fixture(data, TF.lane_world(scale=0.5),
                         TF.lane_trajectory(64)[::4])
    res = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        ini = TF.copy_config(root / f"{name}.ini", **SMALL)
        out = root / f"out_{name}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([str(ini), "--dataset", str(data), "--outDir", str(out),
                       *extra])
        assert rc == 0
        res[name] = _summary(buf.getvalue(), out, data)
    res["root"], res["data"] = root, data
    return res


def test_cli_tracks_like_jax(runs):
    j, t = runs["jax"], runs["port"]
    assert j["tracked"] == 16
    assert t["tracked"] == j["tracked"] == t["matched"]
    assert abs(t["keyframes"] - j["keyframes"]) <= 1 and j["keyframes"] >= 2
    assert abs(t["ate"] - j["ate"]) <= 0.2 * j["ate"], (t["ate"], j["ate"])
    assert t["ate"] < 0.02


def test_cli_writes_the_same_files(runs):
    files = runs["port"]["files"]
    assert files == runs["jax"]["files"]
    for name in ("trajectory_frames_ba.tum", "trajectory_keyframes_ba.tum",
                 "trajectory.ply", "trajectory.npz"):
        assert name in files


def test_cli_needs_a_card_unless_cpu_is_asked(runs, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run on it")
    ini = TF.copy_config(runs["root"] / "nocard.ini", **SMALL)
    rc = port_main([str(ini), "--dataset", str(runs["data"]), "--outDir",
                    str(runs["root"] / "out_nocard")])
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err
    r = subprocess.run([sys.executable, "-m", "snakeslam_tpu_torch",
                        str(ini), "--dataset", str(runs["data"])],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "--device cpu" in r.stderr
