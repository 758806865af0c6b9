"""Each generator module, found by its name through ``make_sequences``,
gives exactly the sequences that were recorded for it, for two seeds:
every file the TUM render writes (at 40 frames of the cell's arc; the
full 300 take ~45 s here) and every array of every feature-level frame,
the warm-up's too.  A digest that moves means a cell's inputs moved."""

import hashlib
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest

from harness import HERE, Cell, load_cell, make_sequences

SEEDS = (2**31 + 99, 4_000_000_007)
KEYS = ("uv", "octave", "angle", "descriptors", "right", "depth",
        "gt_pose_cw", "point_id")
ORBIT = dict(generator="feature_frames", world_points=3000,
             trajectory="orbit", frames=20, arc_rad=0.144, radius_m=7.0,
             fps=10.0, noise_px=0.3, sequences=2, window=8,
             warmup=dict(sequence="own", frames=8, dense_fps=10.0))
LOOP = dict(ORBIT, trajectory="loop", sequences=1,
            warmup=dict(sequence=0, frames=6))
DIGESTS = {
    "orbit": ("494fc50ed1d2bafa8ac5f989dd3f49665cc9874183ec0cd71932db14bf172237",
              "8356e981de9698c2d88e4dc3f709f5fed2c82c1c5a62a9a7c2b931fcc5580c6e"),
    "loop": ("d5542f4000691e993bf9fd1e79f7233b4a3062fcd23ed165e13d1442eb3ffee3",
             "f645fb3f0de57fff2ab7475d903d6be868d9919051e94b23868148bb4cbc9052"),
    "tum": ("5aaf799811242154a10e442312bedd3912f0f7fd31a887644e9103c0c2c61508",
            "1e8e03264526d273ef7845e2ab4e622f7cb1c89ab233d329a70d8347d428e431"),
}


def _array(h, a):
    a = np.ascontiguousarray(a)
    h.update(repr((a.dtype.str, a.shape)).encode())
    h.update(a.tobytes())


def feature_digest(cell, seed, workdir):
    seqs, warm = make_sequences(cell, seed, workdir)
    h = hashlib.sha256()
    for q in seqs + [warm]:
        h.update(repr((q.frames, len(q.raw), q.root, list(q.images)))
                 .encode())
        if q.truth is not None:
            _array(h, q.truth)
        for r in q.raw:
            h.update(repr((r.frame_id, r.timestamp)).encode())
            for k in KEYS:
                _array(h, getattr(r, k))
    return h.hexdigest()


def tum_digest(cell, seed, workdir):
    seqs, warm = make_sequences(cell, seed, workdir)
    h = hashlib.sha256()
    for q in seqs + [warm]:
        h.update(repr((q.frames, str(q.root.relative_to(workdir)),
                       [str(Path(p).relative_to(q.root))
                        for p in q.images])).encode())
    for q in seqs:
        for f in sorted(q.root.rglob("*")):
            if f.is_file():
                h.update(str(f.relative_to(q.root)).encode())
                h.update(f.read_bytes())
    return h.hexdigest()


def _cell(kind):
    if kind == "tum":
        c = load_cell("tum_rgbd_fr1.orbit300")
        t = dict(c.traffic, frames=40, arc_rad=0.9 * 39 / 299)
        return Cell(c.name, c.entry, c.config, t, [], [])
    config = json.loads((HERE / "configs" / "euroc_stereo_vo.json")
                        .read_text())
    return Cell("euroc_stereo_vo.tiny", {"chips": 1}, config,
                ORBIT if kind == "orbit" else LOOP, [], [])


@pytest.mark.parametrize("kind", sorted(DIGESTS))
def test_generator_gives_the_recorded_sequences(kind):
    cell = _cell(kind)
    digest = tum_digest if kind == "tum" else feature_digest
    got = []
    for seed in SEEDS:
        wd = Path(tempfile.mkdtemp(prefix="slambench-gen-"))
        try:
            got.append(digest(cell, seed, wd))
        finally:
            shutil.rmtree(wd, ignore_errors=True)
    assert tuple(got) == DIGESTS[kind]


def test_unknown_generator_names_its_file(tmp_path):
    cell = _cell("orbit")
    cell = Cell(cell.name, cell.entry, cell.config,
                dict(cell.traffic, generator="no_such_generator"), [], [])
    with pytest.raises(FileNotFoundError, match="no_such_generator.py"):
        make_sequences(cell, 1, tmp_path)
