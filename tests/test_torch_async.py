"""The port's async mode: the front-end producer thread, the local BA on
its worker, the back-end queues on worker threads, the windowed runner's
serialized back-end worker, and the viewer's frame stream.

A stereo run of 30 frames with ``async_mode`` and ``async_lba`` through
``SlamSystem.run`` (tests/test_async.py's scenario and thresholds) tracks
all but two frames, ATE < 0.05 m, the local BA ran on its worker, and a
``FrameOverlayWriter`` on ``frame_listeners`` wrote every tenth frame.  The
windowed runner's ``async_backends`` mode tracks a dense-keyframe run with
its keyframe cycles on the worker.  Exceptions on the producer thread and
on the LBA worker reach the caller; a parallel delayed queue runs each
item exactly once under contention.  A monocular initialization with
``async_lba`` runs its local BA synchronously and lands.
"""

import sys
import threading

import pytest
import torch

from snakeslam_tpu_torch.frontend.synthetic_source import (
    apply_world_to_settings,
    synthetic_frames,
)
from snakeslam_tpu_torch.system import pipeline as PL
from snakeslam_tpu_torch.system.queues import DelayedQueue
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.system.slam import SlamSystem
from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
from snakeslam_tpu_torch.utils import vi_problems as VP
from snakeslam_tpu_torch.utils.synthetic import SyntheticWorld, orbit_trajectory
from snakeslam_tpu_torch.viewer.export import FrameOverlayWriter


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the test workers share the machine's cores,
    and oversubscribed thread pools spin on the runs' small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stereo(n_frames=30, async_mode=True):
    world = SyntheticWorld(n_points=3000, seed=51)
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.async_mode = async_mode
    s.async_lba = async_mode
    s.feature_slots = 1024
    s.local_map_slots = 2048
    s.lba_cam_slots = 24
    s.lba_point_slots = 4096
    s.lba_obs_slots = 8
    s.th_depth = 25.0
    apply_world_to_settings(world, s)
    frames = list(synthetic_frames(
        world, orbit_trajectory(n_frames, radius=7.0,
                                arc=0.6 * n_frames / 50), s, noise_px=0.3))
    return s, frames


def test_async_run_tracks_and_exports_frames(tmp_path):
    s, frames = _stereo()
    system = SlamSystem(s, "cpu")
    assert system._simp_queue.parallel and system._async_lba is not None
    writer = FrameOverlayWriter(tmp_path / "frames", every_n=10,
                                size=(s.width, s.height))
    system.frame_listeners.append(writer.on_frame)
    system.run(iter(frames))
    assert len(system.tracker.trajectory) >= len(frames) - 2
    rmse, _, _ = system.ate_against_gt(with_scale=False)
    assert rmse < 0.05, rmse
    assert system.lba.n_runs >= 1
    assert sorted(p.name for p in (tmp_path / "frames").iterdir()) == [
        "frame_000000.png", "frame_000010.png", "frame_000020.png"]


def test_windowed_async_backends_track_dense_keyframes():
    s, frames = _stereo(n_frames=24)
    # the local BA inside the worker's keyframe cycles: on a worker of its
    # own it races the cycles' keyframe insertions, and a commit that finds
    # the map changed is dropped, so its run count would depend on timing
    s.async_lba = False
    for f in frames:
        f.timestamp = f.frame_id / 10.0   # dense keyframes: cycles run
    system = SlamSystem(s, "cpu")
    runner = WindowedRunner(system, window=4)
    assert runner.async_backends
    runner.run(frames)
    assert not runner._pending and system.map.n_keyframes >= 3
    system.finalize()
    assert len(system.tracker.trajectory) == len(frames)
    assert system.lba.n_runs >= 1
    rmse, _, _ = system.ate_against_gt(with_scale=False)
    assert rmse < 0.05, rmse


def test_producer_exception_reaches_the_caller():
    s, frames = _stereo(n_frames=3, async_mode=False)
    system = SlamSystem(s, "cpu")

    def source():
        yield frames[0]
        raise OSError("unreadable image")

    with pytest.raises(OSError, match="unreadable"):
        PL.AsyncPipeline(system, source()).run()
    assert len(system.tracker.trajectory) == 1


def test_lba_worker_exception_reaches_the_caller():
    class Failing:
        def run(self, kf):
            raise ValueError(f"diverged at {kf}")

    lba = PL.AsyncLBA(Failing())
    lba.add(4)
    with pytest.raises(ValueError, match="diverged at 4"):
        lba.join()


def test_parallel_queue_runs_each_item_once():
    """Several producer threads, a short switch interval: every item is
    processed exactly once, in no item's absence."""
    seen = []
    lock = threading.Lock()

    def process(item):
        with lock:
            seen.append(item)

    q = DelayedQueue(process, delay=0, parallel=True, name="stress")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def produce(base):
            for i in range(200):
                q.add(base + i)
                q.update(base + i)

        threads = [threading.Thread(target=produce, args=(k * 1000,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        q.join()
        q.force_clean()
    finally:
        sys.setswitchinterval(old)
    assert sorted(seen) == sorted(k * 1000 + i for k in range(16)
                                  for i in range(200))


def test_mono_initialization_with_async_lba():
    """The initializer's local BA goes through ``AsyncLBA.run`` on the
    caller's thread (the JAX package's ``AsyncLBA`` has no ``run``: its
    monocular initializer raises AttributeError with ``async_lba``)."""
    world = SyntheticWorld(n_points=1500, seed=5)
    s = VP.lane_settings(world, (24, 4096, 8), 25.0, True)
    s.async_lba = True
    system = SlamSystem(s, "cpu")
    for f in VP.lane_frames(s, world, 6, 10.0):
        system.process_frame(f)
    system._async_lba.join()
    assert system.map.n_keyframes >= 2
    assert system.lba.n_runs >= 1
