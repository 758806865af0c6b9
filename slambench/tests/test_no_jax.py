"""A benchmark run loads no module whose top-level name, compared whole,
is jax, jaxlib, flax or snakeslam_tpu; the reference loads nothing of the
program; a run without a card, or in a directory without the program,
exits non-zero and prints no result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import run as RUN
from harness import HERE, REPO

RUN_SESSION = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(2)
import run
from harness import HERE, Cell, Runner, cleanup, run_window, workdir_for
from reference.judge import readings
config = json.loads((HERE / "configs" / "euroc_stereo_vo.json").read_text())
t = dict(generator="feature_frames", trajectory="orbit", arc_rad=0.072,
         radius_m=7.0, fps=10.0, noise_px=0.3, frames=24, sequences=1,
         world_points=2000, window=8,
         warmup={"sequence": "own", "frames": 8, "dense_fps": 10.0})
cell = Cell("euroc_stereo_vo.tiny", {"chips": 1}, config, t, [], [])
wd = workdir_for("t")
r = Runner(cell, 2**31 + 12345, "cpu", wd)
r.warm_up()
rec = run_window(r, 2.0)
readings(rec, cell.config, truth=r.truth)
cleanup(wd)
print(json.dumps({"forbidden": run.forbidden_modules(),
                  "program": "snakeslam_tpu_torch" in sys.modules}))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", RUN_SESSION, str(HERE),
                          str(REPO)], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "program": True}


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import reference.judge, reference.orb, reference.geometry,"
            " reference.roofline;"
            "print(sorted(m for m in sys.modules if m.startswith('snake')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code, str(HERE)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_judge_numbers_import_nothing_of_the_program():
    """Every judge number of a module of its own (``reference/numbers/``)
    loads as the judge loads it, with nothing of the program."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from reference.judge import NUMBERS, load_number;"
            "[load_number(p.stem) for p in sorted(NUMBERS.glob('*.py'))];"
            "print(sorted(m for m in sys.modules if m.startswith('snake')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code, str(HERE)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "snakeslam_tpu_torchx", object())
    assert RUN.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert RUN.forbidden_modules() == ["jax"]


def test_no_card_exits_without_a_result():
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload",
                          "tum_rgbd_fr1.orbit300", "--seed", "4000000000",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_bare_directory_exits_without_a_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload",
                          "tum_rgbd_fr1.orbit300", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert not (Path(tmp_path) / "snakeslam_tpu_torch").exists()
