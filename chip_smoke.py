"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the process
exits non-zero:

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; no CUDA device is an error;
  2. build: the three kernels from snakeslam_tpu_torch/csrc, one nvcc per
     source, all started together;
  3. kernel: the CUDA pose kernel against its plain PyTorch version on the
     card at N = 512 and 1024, stereo and mono, bit-identical on a rerun,
     and timed two ways: ``call_us``, the median CUDA-event interval around
     one wrapper call (host-bound: it holds the wrapper's Python), and
     ``device_us``, the device time per launch from replaying a CUDA graph
     of captured wrapper calls; ``bound_us`` beside them; at N = 1024
     stereo a breakdown: device time by cluster width (4, 8, 16 CTAs) and
     by iteration schedule (0 x 0 to 3 x 3), a graph's per-launch floor
     (a 1-element add), and the wrapper's host time per call beside that
     of its output allocation and of its C call alone;
  4. render: the pixels lane's 160 stereo pairs, once, on the host;
  5. fast kernel: FAST-16 against its plain version on 64 rendered 480x752
     views, the same views at pyramid levels 1-3 and an odd 3x101x157
     batch: bit-identical, reruns bit-identical, timed (call and graph
     device time) beside each level's ``bound_us``;
  6. patch gather: against slicing at tests/test_orb.py's shapes and at
     64 x 480 x 752 with 1000 blocks of 56x256 per image: exact, timed
     beside ``bound_us`` and ``library_us``, one advanced-indexing call
     computing the same blocks (a yardstick the port never calls);
 6b. prng: the RANSACs' threefry draws (core/prng.py) on the card against
     the CPU at the lanes' shapes (256 x 2048, 128 x 1024, 512 x 1024):
     32- and 64-bit words, float32 and float64 uniforms bit for bit and
     the sample indices equal, the card's draws without a host sync;
  7. slice: the smooth stereo lane at full width (6000-point world, seed 7,
     400 frames, 1024 feature slots, 2048 pinned local-map slots, window
     128, two-stage) with the full keyframe back-end (triangulation,
     neighbour fusion, local BA on 32 / 8192 / 8 slots, simplification, the
     deferred mapper) through WindowedRunner on the card, with launch
     counts reset just before the run and read just after; gated against
     the JAX package's CPU run of the same lane (PERF.md); then the
     keyframe cycle's pipelined and blocking ms on the lane's last
     keyframe;
  8. pixels lane: the JAX bench's e2e_pixels lane (2600-point rendered
     world, seed 13, 160 frames of 752x480 uint8 stereo pairs, 1000
     features on 4 levels, chunk 32, window 32) through PixelFrameSequence
     and WindowedRunner, warmed up once and then timed, with launch counts
     reset just before the timed run and read just after; gated against
     the JAX package's CPU run of the same lane (PERF.md);
     (the pixels lane keeps the reduced back-end it was gated with);
  9. CPU against GPU: the smooth lane's first 64 frames, window 16, dense
     keyframes, full back-end, through the port on both devices;
 10. pixels CPU against GPU: one chunk of 8 stereo pairs of the pixels lane
     through stereo_frontend_batch on both devices;
 11. local BA: solve_ba on one LBA-shaped problem (C = 32, P = 2048, M = 8)
     on the card without a host sync, bit-identical on a rerun, against
     the CPU solve; timed;
 12. triangulation: triangulate_pairs_batch over 10 neighbour pairs at
     1024 slots on the card without a host sync, integer outputs identical
     to the CPU's; timed;
 13. loop lane: the JAX bench's loop lane (60000-point world, seed 7, 400
     frames of an outward full orbit at 200 fps, 1024 feature slots, 4096
     pinned local-map slots, LBA slots 32 / 8192 / 8, th_map 400) through
     WindowedRunner (window 64) with the whole system (loop closing,
     relocalization, the keyframe back-end) on the card, then
     ``finalize()``; pose-kernel launches counted apart for tracking, loop
     verification and the end-of-run realign; gated against the JAX
     package's CPU run of the same lane (PERF.md); the run traced
     (utils/lane_trace.py, float32 draws as the JAX run's) and the first
     point where the trace parts from the committed JAX and port-CPU
     traces printed, not gated;
 14. batched pose kernel: the realign's launch (B frames, N = 1024, 4 x 3
     iterations) and a loop verification's (B = 1, 3 x 3) on the inputs the
     loop lane gave them, against the plain version, bit-identical reruns,
     timed beside their bounds;
 15. loop closing CPU against GPU: a 20-keyframe ring with its newest three
     keyframes split off and drifted (utils/loop_problems.py), closed with
     the global-BA polish on both devices; then the pose-graph solve and
     the Sim3 RANSAC of that closure rerun on the card without a host sync
     with the sample indices the closure drew (the PGO bit-identical);
 16. sharded loop lane: the loop lane again with ``n_devices = 4``: every
     full BA (the loop correction's, ``finalize``'s) through the sharded
     step of parallel/multichip.py over a 4-shard mesh (all four shards on
     ``cuda:0`` of a one-card machine); gated against the JAX package's
     CPU run on four virtual devices (scripts/jax_multichip_reference.py;
     PERF.md) and, after ``finalize``, within 1.5x of phase 13's ATE;
     sharded full BAs counted against the loop corrections and
     ``finalize``'s three passes;
 17. multichip: the mesh's placement; the sharded BA step (float64, 3
     iterations) on that lane's whole-map problem (C 128, P 8192, M 16
     slots) on 4 shards against 1 shard, against 4 CPU shards (1e-9
     relative) and a rerun (bit-identical), ms per iteration and peak
     memory for 1 and 4 shards; the sharded matcher at 4096 x 1024
     against ``hamming_matrix`` (exact);
 18. dry run: ``dryrun_multichip(4)`` on the card;
 19. entry: ``entry()``'s fine-tracking step on the card against the CPU
     (inlier counts equal, pose within 2e-4);
 20. mono-VI lane: the JAX bench's mono_vi lane (6000-point world, seed 7,
     240 frames of the excited orbit at 20 fps, monocular, IMU at 200 Hz
     with gyro bias [0.01, -0.008, 0.012] and noise, 1024 feature slots,
     2048 pinned local-map slots, LBA slots 32 / 8192 / 8) through
     WindowedRunner (window 16, two-stage) on the card: monocular two-view
     initialization, the gyro-bias and gravity / scale stages inside the
     run, gyro-predicted windows through the pose kernel's mono rows, then
     ``finalize()`` with the visual-inertial alternation; gated against the
     JAX package's CPU run of the same lane (PERF.md); float64 draws, as
     that run's (x64), the run traced and its first parting from the
     committed traces printed, not gated;
 21. mono pose kernel: a coarse (1 x 3) and a fine (2 x 2) problem of a
     tracked window after the visual-inertial initialization and the
     realign batch of ``finalize()``, all mono rows (``right = -1``), on
     the inputs the lane gave them, against the plain version,
     bit-identical reruns, timed beside their bounds;
 22. IMU solvers: ``solve_scale_gravity`` and ``solve_imu_chain`` in
     float64 at K = 16 and 64 keyframe slots on the CPU and on the card,
     results within 1e-9, ms on both;
 23. mono-VI CPU against GPU: the small configuration that
     tests/test_torch_mono_vi_slice.py runs (3000-point world, seed 5,
     10 fps, window 8), 80 frames of it, on both devices, each drawing
     its own RANSAC hypotheses (the same by construction, float64); the
     card's trace against the CPU run's and the committed traces, printed.

 24. tum_render: the CLI lane's TUM-RGBD-format sequence
     (utils/tum_fixture.py: seed 7, 2000 points in a 5 m room, 300 frames
     of 640x480 at 30 Hz on an inward orbit arc, TUM freiburg1
     intrinsics; gray and 16-bit depth PNGs, the ground truth) written to
     a temporary directory, three frames decoded by the port's reader and
     held against the rendered arrays;
 25. CLI: ``snakeslam_tpu_torch.__main__.main`` in-process on a copy of
     configs/tum.ini over that sequence on the card (launch counts reset
     just before, read just after; host seconds by stage), gated against
     the JAX package's CLI on the CPU over the same files
     (scripts/jax_cli_reference.py; PERF.md); then ``python3 -m
     snakeslam_tpu_torch`` as a subprocess over its first 30 frames;
 26. CLI async: the same with ``async_mode`` and ``async_lba`` on, gated
     against the sync run;
 27. checkpoint: the CLI run's map saved, loaded, every field compared;
 28. depth filter: the RGB-D depth filter at 640x480 on the lane's depth,
     card against CPU, timed; Input over the sequence with the filter off
     and on (features with depth per frame);
 29. TSDF: the lane's first 30 depth frames fused at V = 128 and 256 on
     the card and the CPU, compared and timed;
 30. graphs: the compiled programs (utils/graphs.py) on the inputs the
     lanes gave them (the smooth lane's window, local BA, triangulation
     pool and forward and backward fusion searches; the pixels lane's
     stereo front-end and ORB batch on one of its chunks; the loop lane's
     SearchAndFuse search, point BA and PGO; the mono-VI lane's chain
     solve, full BA and outlier classification in ``finalize``; the CLI
     lane's ORB and coarse and fine tracking steps): a replay of the
     captured CUDA graph against the eager run inside
     ``graphs.disabled()``, bit for bit, and against a rerun; the device
     time of a replay (CUDA events around it) beside the wall time of an
     eager call and of a compiled call; captures, replays, cache entries,
     evictions and pool MiB of every program; gated on the allocator's
     reserved GiB and the graph pools' GiB (``RESERVED_GIB_MAX``,
     ``GRAPH_POOL_GIB_MAX``) with every lane's graphs still held.

The lanes run their compiled programs as graphs (on by default on the
card): each lane's phase line holds its captures and replays (``graphs``)
and the host seconds of each program's calls (``program_host_s``), and
every lane is gated on one replay per call (or one capture for a key met
first) of each program it calls: the window and the local BA; the
triangulation pool and the fusion searches (smooth and loop lanes); the
stereo front-end (pixels lane, with the FAST kernel's launches read from
its replays); ORB (CLI lanes); SearchAndFuse, the global-BA passes and
PGO (loop lanes; the sharded lane's full BAs are the sharded step's);
the chain solve and the global-BA passes (mono-VI lane).  The async CLI
run is gated on a local-BA graph captured on a worker thread and on one
ORB graph captured and replayed on the producer thread, while the main
thread replayed the tracking steps.

``--only a,b`` runs the build and then only the named phases of 6b and
13-30 (``prng``: 6b; ``loop``: 13-15; ``multichip``: 13 and 16-19; ``mono_vi``,
``vi_solvers``, ``mono_vi_cpu_gpu``, ``cli``; ``graphs``: 4, 7, 8, 13,
20, 24, 25 and 30) and prints no result line: for iterating on one lane.

The line before the last is one JSON object with the kernels' names,
routes, launch counts, errors, times (``ms`` per call, ``device_ms`` per
launch; for the pose kernel also the device time of a window replay that
holds it), roofline bounds (``bound_ms``, ``bound_by``: inputs read once and
outputs written once at 3.35 TB/s, operations at 67 TFLOP/s f32, the H100
SXM's published peaks) and library-call times (``library_ms``, null where
no single PyTorch call computes the same function); the last line is the
result.
Imports only the port, numpy and torch.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from snakeslam_tpu_torch.core import prng
from snakeslam_tpu_torch.core.camera import Pinhole
from snakeslam_tpu_torch.core.trajectory import read_tum
from snakeslam_tpu_torch.entry import dryrun_multichip, entry
from snakeslam_tpu_torch.frontend import feature_detector as FD
from snakeslam_tpu_torch.frontend import pixels as PIX
from snakeslam_tpu_torch.frontend.datasets import TumRgbdDataset
from snakeslam_tpu_torch.frontend.depth_processor import (DepthProcessor,
                                                          process_depth)
from snakeslam_tpu_torch.frontend.feature_detector import FeatureDetector
from snakeslam_tpu_torch.frontend.input import Input
from snakeslam_tpu_torch.frontend.preprocess import Preprocess
from snakeslam_tpu_torch.frontend.pixels import (PixelFrameSequence,
                                                 stereo_frontend_batch)
from snakeslam_tpu_torch.frontend.synthetic_source import (
    apply_world_to_settings,
    synthetic_frames,
)
from snakeslam_tpu_torch.imu import state_solver as VIS
from snakeslam_tpu_torch.loop import loop_closing as LC
from snakeslam_tpu_torch.loop.keyframe_database import KeyframeDatabase
from snakeslam_tpu_torch.map import device_mirror as DM
from snakeslam_tpu_torch.map import kf_pool as KFP
from snakeslam_tpu_torch.map import serialization as SER
from snakeslam_tpu_torch.map.serialization import load_map, save_map
from snakeslam_tpu_torch.mapping import fusion as FUS
from snakeslam_tpu_torch.mapping import local_mapping as LM
from snakeslam_tpu_torch.models import tracking_step as TS
from snakeslam_tpu_torch.models import window_step as WS
from snakeslam_tpu_torch.ops import ba as BA
from snakeslam_tpu_torch.ops import imu as IMU
from snakeslam_tpu_torch.ops import matching as MATCH
from snakeslam_tpu_torch.ops import orb as ORB
from snakeslam_tpu_torch.ops import orb_kernels as OK
from snakeslam_tpu_torch.ops import pgo as PGO
from snakeslam_tpu_torch.ops import pose_fused as PF
from snakeslam_tpu_torch.ops import sim3_solver as SIM3
from snakeslam_tpu_torch.ops import tsdf as TSDF
from snakeslam_tpu_torch.ops.descriptors import hamming_matrix
from snakeslam_tpu_torch.optim import gba as GBA
from snakeslam_tpu_torch.optim import lba as LBA
from snakeslam_tpu_torch.optim import simplification as SIMP
from snakeslam_tpu_torch.parallel import multichip as MC
from snakeslam_tpu_torch.system.settings import InputType, Settings
from snakeslam_tpu_torch.ops.triangulate_pairs import triangulate_pairs_batch
from snakeslam_tpu_torch.system import slam as SLAM
from snakeslam_tpu_torch.system.slam import SlamSystem
from snakeslam_tpu_torch.tracking import mono_init as MI
from snakeslam_tpu_torch.tracking import tracker as TR
from snakeslam_tpu_torch.tracking.staging import HostCopy
from snakeslam_tpu_torch.tracking import windowed as WIN
from snakeslam_tpu_torch.tracking.windowed import WindowedRunner
from snakeslam_tpu_torch.utils import cuda_build, graphs
from snakeslam_tpu_torch.utils import graph_cases as GC
from snakeslam_tpu_torch.utils import loop_problems as LP
from snakeslam_tpu_torch.utils import lane_trace as LT
from snakeslam_tpu_torch.utils import tum_fixture as TF
from snakeslam_tpu_torch.utils import vi_problems as VP
from snakeslam_tpu_torch.utils.backend_problems import ba_problem, pair_problem
from snakeslam_tpu_torch.utils.pose_problems import pose_problem
from snakeslam_tpu_torch.utils.render_world import (render_frame,
                                                     render_sequence)
from snakeslam_tpu_torch.utils.synthetic import (SyntheticWorld,
                                                 orbit_trajectory)

POSE_ATOL = 2e-4          # tests/test_pose_pallas.py tolerances
TIMED_CALLS = 100
GRAPH_LAUNCHES = 100      # launches captured per CUDA graph for device time
# the H100 SXM's published peaks: HBM bytes/s
# and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations of the pose refine, counted from its plain version: per
# feature and GN step the residual (~37), Huber weight (5), Jacobian rows
# (~47) and the 27 weighted normal-equation terms (189); per feature and
# chi2 reclassification the residual alone
POSE_OPS_PER_FEATURE_STEP = 278
POSE_OPS_PER_FEATURE_RECLASS = 38
# f32 operations of FAST per pixel: the compass test of the four ring
# pixels 0, 4, 8, 12 (2 threshold adds, 8 compares) for every pixel; the
# full 16-pixel test (2 compares, 3 subtractions and 2 adds per ring pixel,
# the max) for the pixels that pass it; the bit-mask logic is not f32
FAST_OPS_COMPASS = 10
FAST_OPS_FULL = 16 * 7 + 1
PIXELS_FRAMES, PIXELS_CHUNK = 160, 32
# the JAX package's run of the pixels lane on the CPU, in the port's
# back-end configuration (PERF.md): the pixels lane is gated against it
JAX_PIXELS = dict(tracked=160, keyframes=5, ate_m=0.061596934852420904)
# the JAX package's run of the smooth lane on the CPU with its full
# back-end minus loop closing, one window consumed per fetch (PERF.md)
JAX_SMOOTH = dict(tracked=400, keyframes=5, ate_m=0.0035097656632509895,
                  lba_runs=4, triangulated=0, fused=1205)
BA_ATOL = 1e-4            # solve_ba on the card against the CPU
LOOP_FRAMES, LOOP_WINDOW = 400, 64
# the JAX package's run of the loop lane on the CPU, one window per fetch
# (scripts/jax_loop_reference.py; PERF.md): the loop lane is gated against
# it, keyframes within 10% and ATE at most LOOP_ATE_FACTOR of it before and
# after finalize.  The lane's ATE spreads with float32 summation order far
# beyond that factor below it (its trace parts from the JAX run's at a
# keyframe cycle by one point, long before the loop; PERF.md section 6), so
# parity is held on the trace instead, for the unsharded and the sharded
# lane alike (both run the same steps until the first loop correction): the
# first LOOP_TRACE_CYCLES keyframe cycles' counts equal the JAX trace's, and
# the verified loop closes onto the JAX run's candidate keyframe
LOOP_ATE_FACTOR = 1.25
LOOP_TRACE_CYCLES = 5
JAX_LOOP = dict(tracked=400, keyframes=81, points=6280,
                ate_m=0.020929448906971324, loops_closed=1,
                keyframes_final=71, ate_final_m=0.011153146451384117)
# the same run with n_devices = 4 on four virtual XLA CPU devices
# (scripts/jax_multichip_reference.py; PERF.md): every full BA sharded
JAX_LOOP_SHARDED = dict(tracked=400, keyframes=81, points=6282,
                        ate_m=0.021039947559649892, loops_closed=1,
                        keyframes_final=71,
                        ate_final_m=0.012935801278021363)
LOOP_SHARDED_ATE_FACTOR = 1.5   # sharded against unsharded, after finalize
MULTICHIP_SHARDS = 4
MULTICHIP_ITERS = 3
MULTICHIP_RTOL = 1e-9     # the sharded step: 1 shard, CPU, against 4
POSE_BATCHED_ATOL = 1e-5  # batched pose kernel against its plain version
# the mono rows of the pose refine (``right <= 0``: two residual rows, no
# right-image row), counted as POSE_OPS_* are: residual ~30, Huber weight 5,
# two Jacobian rows ~31, the 27 normal-equation terms over two rows 135
POSE_OPS_PER_MONO_FEATURE_STEP = 201
POSE_OPS_PER_MONO_FEATURE_RECLASS = 31
# the JAX package's run of the mono-VI lane on the CPU with x64 on, one
# window per fetch (scripts/jax_mono_vi_reference.py; PERF.md): the mono-VI
# lane draws its hypotheses (float64) and makes its two-view geometry as
# that run does, and is gated against it: the same tracked frames,
# keyframes (also after finalize) and landing frames, points within 1%,
# Sim3 ATE within MONO_VI_ATE_RTOL of it before and after finalize
JAX_MONO_VI = dict(tracked=237, keyframes=20, points=2540,
                   sim3_ate_m=0.008382250966750248,
                   align_scale=1.0002830087818257,
                   bg_err=0.00010931129880072978,
                   landed=dict(mono_init=4, gyro=79, gravity=100),
                   map_transforms=1, windows=17, keyframes_final=14,
                   sim3_ate_final_m=0.0024404790072371646,
                   align_scale_final=1.000703472064119)
MONO_VI_ATE_RTOL = 0.1
MONO_VI_POINTS_RTOL = 0.01
VI_SOLVER_ATOL = 1e-9     # the IMU solvers on the card against the CPU
# mono-VI CPU against GPU (80 frames of the small configuration)
MONO_VI_SMALL_FRAMES = 80
MONO_VI_CENTRE_ATOL = 1e-3   # keyframe centres, metres (metric map)
# the gyro bias is solved from the keyframe rotations, which the two
# devices' float32 tracking leaves ~1e-6 rad apart (measured 2.0e-6)
MONO_VI_BG_ATOL = 1e-5
RING_CENTRE_ATOL = 1e-3   # loop closing's keyframe centres, CPU vs GPU
# the CLI lane: utils/tum_fixture.py's rendered TUM-RGBD sequence (seed 7,
# 2000 points, 300 frames of 640x480 at 30 Hz) through the CLI on
# configs/tum.ini.  Its reference (PERF.md section 2) is the JAX package's
# tracking, mapping and finalize on the CPU over the same files and the
# port's ORB features, dropping matches of reused point slots as the
# port's realign does (scripts/jax_cli_reference.py --drop-stale
# --port-orb): the card computes those features bit for bit, so both
# packages' back-ends start from the same inputs.  Gates: tracked within
# 1%, keyframes within 10%, points within 15%, SE3 ATE within 25%.
CLI_FRAMES = 300
JAX_CLI = dict(tracked=300, keyframes=4, points=1309,
               ate_m=0.003119057390713768)
# the JAX CLI with its own ORB (--drop-stale): its features differ from
# the port's in the last bits, which moves this lane's final keyframe count
# and ATE as far as the two references differ (5 against 4 keyframes,
# 2.62 against 3.12 mm); held to tracked within 1%, keyframes within one,
# points within 15% and ATE at most 2x
JAX_CLI_OWN_ORB = dict(tracked=300, keyframes=5, points=1220,
                       ate_m=0.0026213152162890964)
CLI_CPU_ATOL = 1e-3       # m: the CLI on the CPU against the card, centres
DEPTH_FILTER_FRAMES = 10
DEPTH_RTOL = 1e-5         # the depth filter on the card against the CPU
TSDF_FRAMES = 30
TSDF_TRUNC = 0.15         # m: three voxels at V = 128 over 6 m
TSDF_ATOL = 1e-5          # TSDF on the card against the CPU
# the allocator's reserved GiB and the graph pools' GiB after every lane
# and the graphs phase: growth with each key met (a pool a graph, kept for
# good) fails here
RESERVED_GIB_MAX = 16.0
GRAPH_POOL_GIB_MAX = 10.0


def phase(name: str, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def memory() -> dict:
    """The caching allocator's reserved GiB now and at its peak, the GiB
    the compiled programs' graph pools hold, and the allocator's retries
    so far (a retry frees every cached block, graph pools released by
    dropped graphs included: a synchronizing stall)."""
    st = torch.cuda.memory_stats()
    return dict(reserved_gib=st.get("reserved_bytes.all.current", 0) / 2**30,
                peak_reserved_gib=st.get("reserved_bytes.all.peak", 0) / 2**30,
                graph_pool_gib=sum(v["pool_mib"] for v in
                                   graphs.stats().values()) / 2**10,
                alloc_retries=st.get("num_alloc_retries", 0))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of ``nbytes``
    at the HBM rate and ``ops`` at the f32 rate, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def graph_us(fn, k: int = GRAPH_LAUNCHES, reps: int = 10) -> float:
    """Device time per launch in microseconds: ``k`` calls of ``fn``
    captured in one CUDA graph, the graph replayed ``reps`` times between
    two CUDA events; the median replay over ``k``.  Host time is out of
    the interval, the kernels run back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / k)
    del graph
    return statistics.median(times)


def time_calls_us(fn, n: int = TIMED_CALLS, warmup: int = 10) -> float:
    """Median per-call device time in microseconds over ``n`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return statistics.median(times)


def pose_bound(n: int, outer: int, inner: int, batch: int = 1,
               mono: bool = False) -> tuple[float, str]:
    """The pose refine's roofline bound for ``batch`` problems of ``n``
    features: T_init, points, uv, right, weight, mask and the five camera
    scalars read once, the poses, inlier flags and counts written once.
    ``mono``: every row is a two-row mono residual; the ``right`` column is
    still read (the input layout is the same)."""
    nbytes = batch * (64 + n * (12 + 8 + 4 + 4 + 1) + 64 + n + 4) + 5 * 4
    step, reclass = ((POSE_OPS_PER_MONO_FEATURE_STEP,
                      POSE_OPS_PER_MONO_FEATURE_RECLASS) if mono else
                     (POSE_OPS_PER_FEATURE_STEP,
                      POSE_OPS_PER_FEATURE_RECLASS))
    ops = batch * n * (step * outer * inner + reclass * outer)
    return bound(nbytes, ops)


def host_us(fn, n: int = 200, runs: int = 5) -> float:
    """Host time per call in microseconds: the median over ``runs`` of
    ``n`` back-to-back calls (the device keeps up, so the host sets the
    pace)."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def pose_entry_call(args, kw, cluster: int = 0):
    """A function that launches the pose kernel through its C entry point
    alone, on ``args`` (one problem) into outputs made here, spread over
    ``cluster`` CTAs (0: the width the kernel derives)."""
    T0, pts, uv, right, weight, mask, cam, bf = args
    dev, N = pts.device, pts.shape[0]
    outs = (torch.empty((4, 4), device=dev),
            torch.empty((N,), dtype=torch.bool, device=dev),
            torch.empty((), dtype=torch.int32, device=dev))
    ptrs = [t.data_ptr() for t in (T0, pts, uv, right, weight, mask, *cam,
                                   bf)]
    out_ptrs = [t.data_ptr() for t in outs]
    entry = PF._entry or PF._load_entry()

    def call():
        err = entry(*ptrs, 2.1 ** 2, 2.3 ** 2, 1e-5, kw["outer_iters"],
                    kw["inner_iters"], 1, N, cluster, *out_ptrs,
                    cuda_build.raw_stream(pts))
        check(err == 0, f"pose kernel launch failed ({err}) at C={cluster}")
        return outs
    return call


def pose_host_us(args, kw) -> dict:
    """The pose wrapper's host time per call and that of its parts: its
    one output allocation cut into views of three dtypes, three separate
    allocations in its place, and the ctypes call into the kernel's C
    entry point alone."""
    T0, pts, uv, right, weight, mask, cam, bf = args
    dev, N = pts.device, pts.shape[0]
    f32 = torch.float32

    def three():
        return (torch.empty((4, 4), dtype=f32, device=dev),
                torch.empty((N,), dtype=torch.bool, device=dev),
                torch.empty((), dtype=torch.int32, device=dev))

    def one():
        T_b, n_b, inl_b = torch.empty(68 + N, dtype=torch.uint8,
                                      device=dev).split((64, 4, N))
        return (T_b.view(f32).view((4, 4)), n_b.view(torch.int32).view(()),
                inl_b.view(torch.bool).view((N,)))

    return dict(
        call=host_us(lambda: PF.pose_refine_fused(*args, **kw)),
        outputs_three_allocations=host_us(three),
        outputs_one_allocation_views=host_us(one),
        c_entry_call=host_us(pose_entry_call(args, kw)))


def kernel_phase(dev) -> dict:
    """Kernel vs plain version at the window's slot counts; returns the
    worst error and the N = 1024 stereo times."""
    worst = 0.0
    timing = {}
    for n in (512, 1024):
        for stereo in (True, False):
            args, T_gt = pose_problem(3 + n, n, stereo, dev)
            batched = [t[None] for t in args[:6]] + list(args[6:])
            for outer, inner in ((1, 3), (2, 2)):
                kw = dict(outer_iters=outer, inner_iters=inner)
                T, inl, cnt = PF.pose_refine_fused(*args, **kw)
                T2, inl2, cnt2 = PF.pose_refine_fused(*args, **kw)
                Tr, ir, nr = PF.pose_refine_fused_reference(*batched, **kw)
                torch.cuda.synchronize()
                check(torch.equal(T, T2) and torch.equal(inl, inl2)
                      and int(cnt) == int(cnt2), "kernel rerun not bit-identical")
                err = (T - Tr[0]).abs().max().item()
                agree = (inl == ir[0]).float().mean().item()
                c, cr = int(cnt), int(nr[0])
                worst = max(worst, err)
                check(err <= POSE_ATOL, f"pose error {err} at N={n}")
                check(agree > 0.99, f"inlier agreement {agree} at N={n}")
                check(abs(c - cr) <= max(3, cr // 100),
                      f"inlier counts {c} vs {cr} at N={n}")
                check(np.linalg.norm(T.cpu().numpy()[:3, 3] - T_gt[:3, 3])
                      < 2e-3, f"kernel missed the ground truth at N={n}")
            kw = dict(outer_iters=2, inner_iters=2)
            call_us = time_calls_us(lambda: PF.pose_refine_fused(*args, **kw))
            device_us = graph_us(lambda: PF.pose_refine_fused(*args, **kw))
            us_plain = time_calls_us(
                lambda: PF.pose_refine_fused_reference(*batched, **kw))
            b_ms, b_by = pose_bound(n, 2, 2)
            phase("kernel", n=n, stereo=stereo, iters=[2, 2],
                  max_abs_err=worst, call_us=call_us, device_us=device_us,
                  plain_us=us_plain, bound_us=b_ms * 1e3, bound_by=b_by)
            if n == 1024 and stereo:
                # the cluster width (CTAs a problem is spread over; the
                # kernel derives 8 at N = 1024), through the C entry point
                sweep = {c: graph_us(pose_entry_call(args, kw, c))
                         for c in (4, 8, 16)}
                # where the device time goes: per schedule (outer x inner;
                # 0 x 0 is load, Gram-Schmidt and count alone), beside the
                # per-launch floor of a graph (a 1-element add)
                by_iters = {}
                for o_i in ((0, 0), (1, 0), (1, 1), (1, 2), (1, 3), (2, 2),
                            (3, 3)):
                    kwi = dict(outer_iters=o_i[0], inner_iters=o_i[1])
                    by_iters["x".join(map(str, o_i))] = graph_us(
                        lambda: PF.pose_refine_fused(*args, **kwi))
                one = torch.zeros(1, device=dev)
                floor_us = graph_us(lambda: one.add_(1.0))
                phase("kernel_breakdown", n=n, stereo=stereo,
                      device_us_by_cluster=sweep,
                      device_us_by_iters=by_iters,
                      graph_floor_us=floor_us,
                      host_us=pose_host_us(args, kw))
                timing = dict(ms=call_us / 1e3, device_ms=device_us / 1e3,
                              plain_ms=us_plain / 1e3, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None)
    return dict(max_abs_err=worst, **timing)


def pixels_settings(world) -> Settings:
    """bench.py's _base_settings with the e2e_pixels lane's feature count."""
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.feature_slots = 1024
    s.local_map_slots = 4096
    s.lba_cam_slots = 32
    s.lba_point_slots = 8192
    s.lba_obs_slots = 8
    s.th_depth = 25.0
    apply_world_to_settings(world, s)
    s.fd_features = 1000
    return s


def render_pixels_lane():
    """The e2e_pixels lane's world, settings and uint8 stereo pairs,
    rendered once before any timed region."""
    world = SyntheticWorld(n_points=2600, seed=13)   # 752x480 default
    s = pixels_settings(world)
    t0 = time.perf_counter()
    L, R, ts, gt = [], [], [], []
    for t, T_cw, left, right in render_sequence(
            world, orbit_trajectory(PIXELS_FRAMES, radius=7.0,
                                    arc=1.2 * PIXELS_FRAMES / 400.0,
                                    fps=200.0)):
        L.append(left.astype(np.uint8))
        R.append(right.astype(np.uint8))
        ts.append(t)
        gt.append(T_cw)
    lane = dict(settings=s, L=np.stack(L), R=np.stack(R), ts=ts, gt=gt)
    phase("render", frames=PIXELS_FRAMES, image="752x480 uint8 stereo pairs",
          seconds=time.perf_counter() - t0)
    return lane


def fast_phase(dev, lane) -> dict:
    """FAST kernel vs plain version: 64 views of the lane (the first chunk,
    left and right stacked, as extract_orb_batch stacks them), the same
    views at levels 1-3, and an odd shape.  Returns the level-0 times."""
    s = lane["settings"]
    views = torch.from_numpy(np.concatenate(
        [lane["L"][:PIXELS_CHUNK], lane["R"][:PIXELS_CHUNK]])).to(dev).float()
    B, H, W = views.shape
    cases = [("level0", views)]
    for lvl in range(1, s.fd_levels):
        scale = s.fd_scale_factor ** lvl
        cases.append((f"level{lvl}", ORB._resize_bilinear(
            views, int(round(H / scale)), int(round(W / scale)))))
    cases.append(("odd", views[:3, :101, :157].contiguous()))
    th = float(s.fd_ini_th_fast)
    out = {}
    for name, imgs in cases:
        b_ms, b_by, pass_share = fast_bound(imgs, th)
        sc, co = OK.fast_score_batch(imgs, th)
        sc2, co2 = OK.fast_score_batch(imgs, th)
        sr, cr = OK.fast_score_batch_reference(imgs, th)
        torch.cuda.synchronize()
        check(torch.equal(sc, sc2) and torch.equal(co, co2),
              f"FAST kernel rerun not bit-identical ({name})")
        check(torch.equal(co, cr), f"FAST corners differ ({name})")
        check(torch.equal(sc, sr), f"FAST scores differ ({name})")
        check(int(co.sum()) > 0, f"FAST found no corner ({name})")
        err = (sc - sr).abs().max().item()
        del sc2, co2, sr, cr
        us = time_calls_us(lambda: OK.fast_score_batch(imgs, th))
        device_us = graph_us(lambda: OK.fast_score_batch(imgs, th), k=10)
        us_plain = time_calls_us(
            lambda: OK.fast_score_batch_reference(imgs, th))
        phase("fast_kernel", case=name, shape=list(imgs.shape),
              corners=int(co.sum()), max_abs_err=err, kernel_us=us,
              device_us=device_us, plain_us=us_plain, bound_us=b_ms * 1e3,
              bound_by=b_by, share_of_bound=b_ms * 1e3 / device_us,
              compass_pass_share=pass_share)
        if name == "level0":
            out = dict(max_abs_err=err, ms=us / 1e3,
                       device_ms=device_us / 1e3, plain_ms=us_plain / 1e3,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


def fast_bound(imgs, th: float) -> tuple[float, str, float]:
    """FAST's roofline bound on ``imgs``: 4 bytes read and 5 written per
    pixel (score and corner flag); the compass test for every pixel and
    the full test for the pixels this input passes through it.  Also
    returns the share of pixels that pass the compass test."""
    c = imgs[:, 3:-3, 3:-3]
    hi, lo = c + th, c - th
    compass = [imgs[:, :-6, 3:-3], imgs[:, 3:-3, 6:], imgs[:, 6:, 3:-3],
               imgs[:, 3:-3, :-6]]          # ring pixels 0, 4, 8, 12
    n, e, s, w = compass
    # the kernel's exact reject: a bright (dark) pixel at N or S, and at E
    # or W
    pass_b = ((n > hi) | (s > hi)) & ((e > hi) | (w > hi))
    pass_d = ((n < lo) | (s < lo)) & ((e < lo) | (w < lo))
    n_pass = int((pass_b | pass_d).sum())
    n_px = imgs.numel()
    return (*bound(9 * n_px, FAST_OPS_COMPASS * n_px + FAST_OPS_FULL * n_pass),
            n_pass / n_px)


def patch_phase(dev) -> dict:
    """Patch gather vs slicing: tests/test_orb.py's inputs, then 1000
    blocks of 56x256 per image of a 64 x 480 x 752 batch (3.7 GB out)."""
    out = {}
    rng = np.random.default_rng(0)
    cases = []
    img = rng.uniform(0, 255, (2, 104, 384)).astype(np.float32)
    yt = rng.integers(0, (104 - 48) // 8, (2, 13)).astype(np.int32)
    xt = rng.integers(0, (384 - 128) // 128 + 1, (2, 13)).astype(np.int32)
    cases.append(("test_orb", img, yt, xt, 48, 128))
    B, H, W, N = 64, 480, 752, 1000
    img = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    yt = rng.integers(0, (H - 56) // 8 + 1, (B, N)).astype(np.int32)
    xt = rng.integers(0, (W - 256) // 128 + 1, (B, N)).astype(np.int32)
    cases.append(("lane", img, yt, xt, 56, 256))
    for name, img, yt, xt, sy, sx in cases:
        args = [torch.from_numpy(a).to(dev) for a in (img, yt, xt)]
        got = OK.patch_gather(*args, sy, sx)
        want = OK.patch_gather_reference(*args, sy, sx)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"patch gather differs ({name})")
        del got, want
        # the kernel's launch against the plain version, neither with the
        # wrapper's bounds check (a reduction and a host sync), which is
        # timed on its own line
        n = 20 if name == "lane" else TIMED_CALLS
        us = time_calls_us(lambda: OK._launch_patch(*args, sy, sx), n=n,
                           warmup=3)
        us_plain = time_calls_us(
            lambda: OK.patch_gather_reference(*args, sy, sx), n=n, warmup=3)
        us_wrapper = time_calls_us(lambda: OK.patch_gather(*args, sy, sx),
                                   n=n, warmup=3)
        # the yardstick: one advanced-indexing call on index tensors made
        # beforehand (the port never calls it)
        im, y, x = args
        rows = y.long()[..., None] * 8 + torch.arange(sy, device=dev)
        cols = x.long()[..., None] * 128 + torch.arange(sx, device=dev)
        bidx = torch.arange(im.shape[0], device=dev)[:, None, None, None]
        r, c = rows[..., :, None], cols[..., None, :]
        us_library = time_calls_us(lambda: im[bidx, r, c], n=n, warmup=3)
        del rows, cols, bidx, r, c
        B, H, W = img.shape
        N = yt.shape[1]
        b_ms, b_by = bound(4 * B * H * W + 2 * 4 * B * N
                           + 4 * B * N * sy * sx, 0)
        phase("patch_gather", case=name, shape=list(img.shape),
              blocks=N, block=[sy, sx], max_abs_err=0.0,
              kernel_us=us, plain_us=us_plain, wrapper_us=us_wrapper,
              library_us=us_library, bound_us=b_ms * 1e3, bound_by=b_by,
              share_of_bound=b_ms * 1e3 / us)
        out = dict(max_abs_err=0.0, ms=us / 1e3, device_ms=us / 1e3,
                   plain_ms=us_plain / 1e3, bound_ms=b_ms, bound_by=b_by,
                   library_ms=us_library / 1e3)
        del args, im, y, x
    torch.cuda.empty_cache()
    return out


def reduce_backend(system):
    """The keyframe back-end cut to its synchronous half (no triangulation,
    fusion, local BA or back-end queues): the configuration the pixels
    lane's JAX reference ran in."""
    lm = system.local_mapper
    lm.lba = None
    lm.map_searcher = None
    lm.backends = []
    lm._tri_dispatch = lambda *a, **k: None


def pixels_run(lane, dev):
    s = lane["settings"]
    system = SlamSystem(s, dev)
    reduce_backend(system)
    seq = PixelFrameSequence(s, lane["L"], lane["R"], lane["ts"], lane["gt"],
                             chunk=PIXELS_CHUNK, device=dev)
    return system, seq, WindowedRunner(system, window=PIXELS_CHUNK)


def pixels_phase(dev, lane) -> dict:
    system, seq, runner = pixels_run(lane, dev)
    runner.run(seq)                       # warm-up
    torch.cuda.synchronize()

    system, seq, runner = pixels_run(lane, dev)
    g0 = graph_counts()
    with contextlib.ExitStack() as stack:
        keep = stack.enter_context(KeepInputs(PIX, "stereo_frontend_batch",
                                              dev))
        probes = program_probes(stack, ("stereo_frontend",))
        OK.FAST_LAUNCHES = 0
        PF.LAUNCHES = 0
        t0 = time.perf_counter()
        runner.run(seq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fast, pose = OK.FAST_LAUNCHES, PF.LAUNCHES
    g = graph_delta(g0)
    tracked = len(system.tracker.trajectory)
    ate, _, _ = system.ate_against_gt(with_scale=False)
    levels = lane["settings"].fd_levels
    chunks = -(-PIXELS_FRAMES // PIXELS_CHUNK)
    phase("pixels_lane", draw=draw_name(), frames=PIXELS_FRAMES,
          tracked=tracked,
          keyframes=system.map.n_keyframes, points=system.map.n_points,
          ate_m=ate, wall_s=wall, fps=tracked / wall,
          image="752x480 uint8 stereo pairs, 1000 features",
          fast_launches=fast, pose_launches=pose,
          device_calls=runner.n_device_calls, graphs=g,
          program_host_s=program_host_s(probes), memory=memory(),
          jax_cpu=JAX_PIXELS, card=card_line())
    check_one_replay_per_call(g, dict(window_track=runner.n_device_calls))
    check_programs("pixels_lane", g, probes, required=("stereo_frontend",))
    check(probes["stereo_frontend"].calls == chunks,
          f"{probes['stereo_frontend'].calls} front-end calls for {chunks} "
          "chunks")
    check(fast == levels * chunks,
          f"{fast} FAST launches for {chunks} chunks of {levels} levels")
    check(pose == 2 * runner.window * runner.n_device_calls,
          f"{pose} pose launches for {runner.n_device_calls} windows")
    check(tracked == JAX_PIXELS["tracked"],
          f"pixels lane tracked {tracked}, the JAX run {JAX_PIXELS['tracked']}")
    check(abs(system.map.n_keyframes - JAX_PIXELS["keyframes"]) <= 1,
          f"pixels lane {system.map.n_keyframes} keyframes, the JAX run "
          f"{JAX_PIXELS['keyframes']}")
    check(abs(ate - JAX_PIXELS["ate_m"]) <= 0.2 * JAX_PIXELS["ate_m"],
          f"pixels lane ATE {ate} m, the JAX run {JAX_PIXELS['ate_m']} m")
    # the ORB batch program on a chunk's views, stacked as the front-end
    # stacks them (no lane calls it on its own)
    prog, (a, k) = keep.kept()
    orb_batch = (ORB.extract_orb_batch, (
        (torch.cat([a[0], a[1]]).to(torch.float32),),
        {n: k[n] for n in ("n_features", "levels", "scale_factor",
                           "threshold")}))
    return dict(fast=fast, pose=pose, kept=dict(stereo_frontend=(prog, (a, k)),
                                                orb_batch=orb_batch))


def _features(outs, b):
    """{(octave, u, v): (descriptor bytes, depth)} of frame b's valid
    features."""
    uv, octave, _, packed, valid, _, depth = (a[b].cpu().numpy()
                                              for a in outs)
    return {(int(o), float(u), float(v)): (d.tobytes(), float(z))
            for o, (u, v), d, z in zip(octave[valid], uv[valid],
                                       packed[valid], depth[valid])}


def pixels_cpu_gpu_phase(dev, lane):
    """One chunk of 8 stereo pairs through stereo_frontend_batch on both
    devices: level 0 identical; over all levels >= 99% of features common,
    >= 99% of those with equal descriptors; stereo flags >= 99% equal.
    (Levels 1-3 come from f32 matrix products that cuBLAS and the CPU round
    differently in the last ulps.)"""
    s = lane["settings"]
    kw = dict(bf=float(s.bf), n_features=int(s.fd_features),
              levels=int(s.fd_levels), scale_factor=float(s.fd_scale_factor),
              threshold=float(s.fd_ini_th_fast),
              relaxed=bool(s.fd_relaxed_stereo))
    L = torch.from_numpy(lane["L"][:8])
    R = torch.from_numpy(lane["R"][:8])
    cpu = stereo_frontend_batch(L, R, **kw)
    gpu = stereo_frontend_batch(L.to(dev), R.to(dev), **kw)
    torch.cuda.synchronize()
    n_all = n_common = n_desc = n_flags = 0
    l0 = dict(keys=0, desc=0, depth=0, n=0)
    for b in range(8):
        fc, fg = _features(cpu, b), _features(gpu, b)
        common = [k for k in fc if k in fg]
        n_all += max(len(fc), len(fg))
        n_common += len(common)
        n_desc += sum(fc[k][0] == fg[k][0] for k in common)
        n_flags += sum((fc[k][1] > 0) == (fg[k][1] > 0) for k in common)
        c0 = {k for k in fc if k[0] == 0}
        g0 = {k for k in fg if k[0] == 0}
        l0["n"] += len(c0)
        l0["keys"] += len(c0 ^ g0)
        l0["desc"] += sum(fc[k][0] != fg[k][0] for k in c0 & g0)
        l0["depth"] += sum(fc[k][1] != fg[k][1] for k in c0 & g0)
    phase("pixels_cpu_vs_gpu", draw=draw_name(), frames=8, features=n_all,
          common=n_common,
          equal_desc=n_desc, equal_stereo_flag=n_flags,
          level0_features=l0["n"], level0_key_mismatch=l0["keys"],
          level0_desc_mismatch=l0["desc"], level0_depth_mismatch=l0["depth"])
    check(l0["n"] > 0 and l0["keys"] == 0 and l0["desc"] == 0,
          "level-0 features differ between CPU and GPU")
    check(l0["depth"] == 0, "level-0 stereo depths differ between CPU and GPU")
    check(n_common >= 0.99 * n_all, f"{n_common} of {n_all} features common")
    check(n_desc >= 0.99 * n_common, f"{n_desc} of {n_common} descriptors")
    check(n_flags >= 0.99 * n_common, f"{n_flags} of {n_common} stereo flags")


def smooth_settings(world) -> Settings:
    s = Settings()
    s.input_type = InputType.Stereo
    s.enable_imu = False
    s.feature_slots = 1024
    s.local_map_slots = 2048
    s.pin_local_map_bucket = True
    s.lba_cam_slots = 32          # bench._base_settings' LBA slots
    s.lba_point_slots = 8192
    s.lba_obs_slots = 8
    s.th_depth = 25.0
    apply_world_to_settings(world, s)
    return s


def backend_counts(system) -> dict:
    return dict(lba_runs=system.lba.n_runs,
                triangulated=system.local_mapper.n_triangulated,
                fused=system.local_mapper.map_searcher.n_fused,
                culled=system.simplification.n_culled)


def smooth_lane(seed: int, count: int, dev, dense: bool = False):
    world = SyntheticWorld(n_points=6000, seed=seed)
    s = smooth_settings(world)
    system = SlamSystem(s, dev)
    frames = list(synthetic_frames(
        world, orbit_trajectory(count, radius=7.0, arc=1.2 * count / 400.0,
                                fps=200.0),
        s, noise_px=0.3))
    if dense:
        for f in frames:
            f.timestamp = f.frame_id / 10.0
    return system, frames


def slice_phase(dev):
    # warm-up as the bench does: dense keyframes exercise every path once
    system, frames = smooth_lane(123, 48, dev, dense=True)
    WindowedRunner(system, window=128).run(frames)
    torch.cuda.synchronize()

    system, frames = smooth_lane(7, 400, dev)
    runner = WindowedRunner(system, window=128)
    g0 = graph_counts()
    backend = ("triangulate_pool", "fuse_pool")
    with contextlib.ExitStack() as stack:
        win = stack.enter_context(KeepInputs(WIN, "window_track", dev))
        lba = stack.enter_context(KeepInputs(LBA, "solve_window", dev))
        # the pool search into the neighbours' 16 rows, and into the
        # keyframe's own row: one program, two keys (installed in turn)
        keep = {"triangulate_pool": stack.enter_context(KeepInputs(
            *PROGRAM_SITES["triangulate_pool"], dev, nth=1))}
        for n, rows in (("fuse_pool", FUS.FUSE_NB), ("fuse_pool_row", 1)):
            keep[n] = stack.enter_context(KeepInputs(
                *PROGRAM_SITES["fuse_pool"], dev,
                when=lambda a, k, rows=rows: len(a[1]) == rows))
        probes = program_probes(stack, backend)
        PF.LAUNCHES = 0
        t0 = time.perf_counter()
        runner.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = PF.LAUNCHES
    g = graph_delta(g0)
    tracked = len(system.tracker.trajectory)
    ate, _, _ = system.ate_against_gt(with_scale=False)
    counts = backend_counts(system)
    phase("slice", draw=draw_name(), frames=len(frames), tracked=tracked,
          keyframes=system.map.n_keyframes, points=system.map.n_points,
          ate_m=ate, wall_s=wall, fps=tracked / wall, launches=launches,
          device_calls=runner.n_device_calls, graphs=g,
          window_replays_per_call=g.get("window_track", {}).get(
              "replays", 0) / runner.n_device_calls,
          program_host_s=program_host_s(probes), memory=memory(),
          **counts, jax_cpu=JAX_SMOOTH, card=card_line())
    check(tracked == JAX_SMOOTH["tracked"], f"tracked {tracked} of 400 frames")
    check(abs(system.map.n_keyframes - JAX_SMOOTH["keyframes"]) <= 1,
          f"{system.map.n_keyframes} keyframes, the JAX run "
          f"{JAX_SMOOTH['keyframes']}")
    check(abs(ate - JAX_SMOOTH["ate_m"]) <= 0.2 * JAX_SMOOTH["ate_m"],
          f"ATE {ate} m, the JAX run {JAX_SMOOTH['ate_m']} m")
    check(counts["lba_runs"] >= 1 and counts["fused"] >= 1,
          f"the keyframe back-end did not run: {counts}")
    for k in ("lba_runs", "triangulated", "fused"):
        check(abs(counts[k] - JAX_SMOOTH[k]) <= 0.1 * JAX_SMOOTH[k],
              f"{k} {counts[k]}, the JAX run {JAX_SMOOTH[k]}")
    check(launches == 2 * runner.window * runner.n_device_calls,
          f"{launches} kernel launches for {runner.n_device_calls} windows")
    # every call of the window and local-BA programs is one replay, or the
    # capture of a key the warm-up run did not meet
    check_one_replay_per_call(g, dict(window_track=win.calls,
                                      lba_solve=lba.calls))
    check(win.calls == runner.n_device_calls,
          f"{win.calls} window calls for {runner.n_device_calls} windows")
    check_programs("slice", g, probes, required=backend)
    return launches, system, dict(window_track=win.kept(),
                                  lba_solve=lba.kept(),
                                  **{n: k.kept() for n, k in keep.items()})


def kf_cycle_phase(system, reps: int = 3):
    """The keyframe cycle (triangulation fan-out, bidirectional fusion,
    local BA) on the lane's last keyframe, as bench._bench_kf_cycle
    measures it: blocking = one dispatch -> readback, the median of
    ``reps`` after one warm-up; pipelined = ms per cycle with cycle k + 1
    dispatched before cycle k's readback (the runner's schedule)."""
    lm = system.tracker.local_mapper
    kf = int(system.tracker.last_kf)

    def one_dispatch():
        tri = lm._tri_dispatch(kf)
        fuse = lm.map_searcher.dispatch(kf)
        ba = lm.lba.dispatch(kf)
        arrays = []
        if tri is not None:
            arrays += [tri[0]["valid"], tri[0]["match_b"], tri[0]["point"]]
        if fuse is not None:
            arrays += fuse[0]
        if ba is not None:
            arrays += ba[0]
        check(tri is not None and fuse is not None and ba is not None,
              "the keyframe cycle did not dispatch all three stages")
        return HostCopy(arrays)

    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        one_dispatch().wait()
        times.append(time.perf_counter() - t0)
    blocking_ms = statistics.median(times[1:]) * 1e3
    n_pipe = 2 * reps + 2
    prev = one_dispatch()
    t0 = time.perf_counter()
    for _ in range(n_pipe):
        cur = one_dispatch()
        prev.wait()
        prev = cur
    prev.wait()
    pipelined_ms = (time.perf_counter() - t0) / (n_pipe + 1) * 1e3
    phase("kf_cycle", keyframe=kf, blocking_ms=blocking_ms,
          pipelined_ms=pipelined_ms)


def ba_phase(dev):
    """solve_ba on the card: no host sync, a bit-identical rerun, poses and
    points within BA_ATOL of the CPU solve; timed against the CPU."""
    prob, cam, bf = ba_problem(32, 2048, 8, 0, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = BA.solve_ba(prob, cam, bf, iterations=3)
        again = BA.solve_ba(prob, cam, bf, iterations=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "solve_ba rerun not bit-identical")
    cprob, ccam, cbf = ba_problem(32, 2048, 8, 0, "cpu")
    t0 = time.perf_counter()
    ref = BA.solve_ba(cprob, ccam, cbf, iterations=3)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err_pose = (out[0].cpu() - ref[0]).abs().max().item()
    err_pts = (out[1].cpu() - ref[1]).abs().max().item()
    ms = time_calls_us(lambda: BA.solve_ba(prob, cam, bf, iterations=3),
                       n=20, warmup=3) / 1e3
    phase("solve_ba", C=32, P=2048, M=8, iterations=3,
          max_abs_err_pose=err_pose, max_abs_err_points=err_pts,
          cost_gpu=float(out[2]), cost_cpu=float(ref[2]), gpu_ms=ms,
          cpu_ms=cpu_ms, rerun_bit_identical=True)
    check(err_pose <= BA_ATOL, f"solve_ba poses differ by {err_pose}")
    check(err_pts <= BA_ATOL, f"solve_ba points differ by {err_pts}")


def triangulation_phase(dev):
    """triangulate_pairs_batch over 10 neighbour pairs at the lane's 1024
    slots: no host sync, integer outputs identical to the CPU's."""
    kw = pair_problem(1024, 10, 1, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = triangulate_pairs_batch(**kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ckw = pair_problem(1024, 10, 1, "cpu")
    t0 = time.perf_counter()
    ref = triangulate_pairs_batch(**ckw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same = {k: torch.equal(out[k].cpu(), ref[k])
            for k in ("valid", "match_b", "far_away", "n_new")}
    v = ref["valid"]
    err = (out["point"].cpu()[v] - ref["point"][v]).norm(dim=-1)
    rel = (err / ref["point"][v].norm(dim=-1)).max().item()
    ms = time_calls_us(lambda: triangulate_pairs_batch(**kw), n=20,
                       warmup=3) / 1e3
    phase("triangulate_pairs", pairs=10, slots=1024, valid=int(v.sum()),
          identical=same, max_rel_point_err=rel, gpu_ms=ms, cpu_ms=cpu_ms)
    check(all(same.values()), f"CPU and GPU triangulation differ: {same}")
    check(int(v.sum()) > 0, "no triangulated point")


def _centres(system) -> dict:
    return {f.frame_id: np.linalg.inv(system.frame_pose_global(f))[:3, 3]
            for f in system.tracker.trajectory}


def cpu_gpu_phase(dev):
    """64 dense-keyframe frames with the full back-end on both devices:
    the run that makes every back-end fire (triangulation, fusion, local
    BA, simplification)."""
    out = {}
    for d in ("cpu", dev):
        system, frames = smooth_lane(7, 400, d, dense=True)
        WindowedRunner(system, window=16).run(frames[:64])
        out[str(d)] = system
    c, g = out["cpu"], out[str(dev)]
    cc, gc = _centres(c), _centres(g)
    diff = max(np.linalg.norm(cc[k] - gc[k]) for k in cc) if cc else np.inf
    bc, bg = backend_counts(c), backend_counts(g)
    phase("cpu_vs_gpu", draw=draw_name(),
          tracked_cpu=len(c.tracker.trajectory),
          tracked_gpu=len(g.tracker.trajectory),
          keyframes_cpu=c.map.n_keyframes, keyframes_gpu=g.map.n_keyframes,
          points_cpu=c.map.n_points, points_gpu=g.map.n_points,
          backend_cpu=bc, backend_gpu=bg, max_centre_diff_m=float(diff))
    check(len(c.tracker.trajectory) == len(g.tracker.trajectory) == 64,
          "CPU and GPU tracked counts differ")
    check(cc.keys() == gc.keys(), "CPU and GPU tracked different frames")
    check(c.map.n_keyframes == g.map.n_keyframes,
          "CPU and GPU keyframe counts differ")
    check(diff < 1e-3, f"camera centres differ by {diff} m")
    for k in ("lba_runs", "triangulated", "fused", "culled"):
        check(bg[k] >= 1, f"no {k} on the card: {bg}")
        check(abs(bg[k] - bc[k]) <= 0.1 * bc[k],
              f"{k}: GPU {bg[k]}, CPU {bc[k]}")


class Probe:
    """While installed, records the calls of ``owner.name``: their count,
    the host seconds inside them (inclusive: a call nested in another
    probed one counts in both), the pose-kernel launches they made, the
    arguments of the last one and, with ``keep``, their return values;
    ``after(args, kwargs)`` runs after each call."""

    def __init__(self, owner, name, keep: bool = False, after=None):
        self.owner, self.name, self.keep = owner, name, keep
        self.after = after
        self.inner = getattr(owner, name)
        self.calls = self.launches = 0
        self.seconds = 0.0
        self.out, self.args = [], None

    def __enter__(self):
        def wrapped(*a, **k):
            n0, t0 = PF.LAUNCHES, time.perf_counter()
            self.args = (a, k)
            try:
                r = self.inner(*a, **k)
            finally:
                self.calls += 1
                self.launches += PF.LAUNCHES - n0
                self.seconds += time.perf_counter() - t0
            if self.keep:
                self.out.append(r)
            if self.after is not None:
                self.after(a, k)
            return r
        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.inner)


def graph_counts() -> dict:
    """{compiled program: (captures, replays)} so far."""
    return {p.name: (p.captures, p.replays) for p in graphs.programs()}


def graph_delta(before: dict) -> dict:
    """Captures and replays of each compiled program since ``before``
    (``graph_counts()``), for the programs that ran."""
    out = {}
    for name, (c, r) in graph_counts().items():
        c0, r0 = before.get(name, (0, 0))
        if (c, r) != (c0, r0):
            out[name] = dict(captures=c - c0, replays=r - r0)
    return out


def _to_card(x, dev):
    """A copy of an argument tree with every tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_card(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_card(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to_card(v, dev) for k, v in x.items()}
    return x


def check_one_replay_per_call(delta: dict, calls: dict):
    """Each program in ``calls`` ran one replay a call, or a capture for a
    key met for the first time (``delta``: ``graph_delta``)."""
    for name, n in calls.items():
        d = delta.get(name, dict(captures=0, replays=0))
        check(d["replays"] + d["captures"] == n and n > 0,
              f"{name}: {d} for {n} calls")


# where the lanes call the compiled programs of the keyframe back-end, the
# front-ends, the IMU solver, loop closing and finalize: (module, name)
PROGRAM_SITES = {name: (importlib.import_module(module), attr)
                 for name, (module, attr) in GC.SITES.items()}


# where the lanes call the device functions the JAX package jits and the
# port runs eagerly (ROADMAP.md queue D)
EAGER_SITES = {
    "sim3_ransac": (LC, "sim3_ransac"),
    "_gather_points": (DM, "_gather_points"),
    "KFFeaturePool._upload": (KFP.KFFeaturePool, "_upload"),
    "solve_scale_gravity": (IMU, "solve_scale_gravity"),
    "knn2_ratio_match": (MATCH, "knn2_ratio_match"),
    "GlobalBA.rematch_intermediate": (GBA.GlobalBA, "rematch_intermediate"),
}


def program_probes(stack, names, sites=PROGRAM_SITES) -> dict:
    """A Probe (calls, host seconds) on the call site of each named
    program (``sites``: name -> (owner, attribute)), entered on
    ``stack``."""
    return {n: stack.enter_context(Probe(*sites[n])) for n in names}


def program_host_s(probes: dict) -> dict:
    """{program: [host seconds, calls]} of ``program_probes``' probes."""
    return {n: [p.seconds, p.calls] for n, p in probes.items()}


def check_programs(lane: str, delta: dict, probes: dict, required=()):
    """Every program in ``required`` ran in the lane, and each probed
    program ran one replay a call, or one capture for a key met first
    (``delta``: ``graph_delta`` over the same interval)."""
    for n in required:
        check(probes[n].calls > 0, f"{lane}: {n} was never called")
    check_one_replay_per_call(delta, {n: p.calls for n, p in probes.items()
                                      if p.calls})


class KeepInputs:
    """While installed in place of the compiled program ``owner.name``,
    keeps a copy on the card of the arguments of its ``nth`` call (with
    ``armed``: of its first call while ``armed()`` is true; with ``when``:
    of its first call whose arguments ``when(args, kwargs)`` accepts),
    taken before the call: a program's static outputs passed back in,
    such as the window's carry, are overwritten by later replays.  Two
    may be installed on one site; each keeps the program itself."""

    def __init__(self, owner, name, dev, nth: int = 2, armed=None,
                 when=None):
        self.owner, self.name, self.dev, self.nth = owner, name, dev, nth
        self.armed, self.when = armed, when
        self.inner = getattr(owner, name)
        self.prog = getattr(self.inner, "program", self.inner)
        self.calls = 0
        self.args = None

    def _wanted(self, a, k) -> bool:
        if self.when:
            return self.when(a, k)
        return self.armed() if self.armed else self.calls == self.nth

    def __enter__(self):
        def wrapped(*a, **k):
            self.calls += 1
            if self.args is None and self._wanted(a, k):
                self.args = (_to_card(a, self.dev), _to_card(k, self.dev))
            return self.inner(*a, **k)
        wrapped.program = self.prog
        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.inner)

    def kept(self):
        check(self.args is not None,
              f"{self.name} was called {self.calls} times, fewer than "
              f"{self.nth}")
        return self.prog, self.args


def loop_lane_phase(dev, n_devices: int = 1, unsharded=None) -> dict:
    """The loop lane with ``n_devices`` shards for the global BA, then
    ``finalize()``; gated on the JAX package's CPU run with as many
    devices (``JAX_LOOP``, ``JAX_LOOP_SHARDED``) and, sharded, on the
    unsharded lane's run (``unsharded``) of the same script."""
    system, frames = LT.build_loop_lane(dev, LOOP_FRAMES, n_devices)
    runner = WindowedRunner(system, window=LOOP_WINDOW)
    lc = system.loop_closing
    correct_ms = []
    inner_correct = lc._correct_loop

    def timed_correct(*a, **k):
        t0 = time.perf_counter()
        try:
            return inner_correct(*a, **k)
        finally:
            correct_ms.append((time.perf_counter() - t0) * 1e3)

    lc._correct_loop = timed_correct
    # where the host's time goes (inclusive seconds per method)
    timed = [Probe(WindowedRunner, "_dispatch"),
             Probe(WindowedRunner, "_consume"),
             Probe(WindowedRunner, "_local_map"),
             Probe(WIN._InFlight, "fetch"),
             Probe(SlamSystem, "process_frame"),
             Probe(LM.LocalMapper, "dispatch_deferred"),
             Probe(LM.LocalMapper, "_tri_dispatch"),
             Probe(FUS.MapSearcher, "dispatch"),
             Probe(LBA.LocalBA, "dispatch"),
             Probe(LM.LocalMapper, "commit_deferred"),
             Probe(LC.LoopClosing, "process"),
             Probe(LM.LocalMapper, "process_sync")]
    loop_programs = ("triangulate_pool", "fuse_pool", "fuse_search_single",
                     "gba_full_ba", "gba_point_ba", "gba_outliers", "pgo")
    gba_programs = ("gba_full_ba", "gba_point_ba", "gba_outliers")
    with contextlib.ExitStack() as stack:
        keep = {n: stack.enter_context(KeepInputs(*PROGRAM_SITES[n], dev,
                                                  nth=1))
                for n in ("fuse_search_single", "gba_point_ba", "pgo")}
        for t in timed:
            stack.enter_context(t)
        probes = program_probes(stack, loop_programs)
        eager = program_probes(stack, ("sim3_ransac", "_gather_points",
                                       "KFFeaturePool._upload"), EAGER_SITES)
        verify = stack.enter_context(Probe(LC, "_verify_search_refine"))
        verify_kernel = stack.enter_context(Probe(LC, "pose_refine_fused"))
        full = stack.enter_context(Probe(GBA.GlobalBA, "full_ba"))
        sharded = stack.enter_context(
            Probe(GBA.GlobalBA, "_sharded_full_ba"))
        # the lane's trace, to find where it parts from the committed
        # traces of the same lane (float32 draws, as the JAX reference's)
        trace = stack.enter_context(LT.LaneTrace(system, MI, LC))
        g0 = graph_counts()
        PF.LAUNCHES = 0
        t0 = time.perf_counter()
        runner.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = PF.LAUNCHES
    g = graph_delta(g0)
    host_s = {f"{t.owner.__name__}.{t.name}": [t.seconds, t.calls]
              for t in timed}
    tracked = len(system.tracker.trajectory)
    kfs, pts = system.map.n_keyframes, system.map.n_points
    ate, _, _ = system.ate_against_gt(with_scale=False)
    loops = lc.n_loops_closed
    # the lane's whole-map BA problem before finalize, for the multichip
    # phase (float64, buckets C 128, P 8192, M 16)
    problem = lc.gba.pack_full()[0] if n_devices > 1 else None
    with contextlib.ExitStack() as stack:
        realign = stack.enter_context(Probe(
            GBA.GlobalBA, "realign_intermediate_frames", keep=True))
        realign_kernel = stack.enter_context(Probe(GBA, "pose_refine_fused"))
        full_fin = stack.enter_context(Probe(GBA.GlobalBA, "full_ba"))
        sharded_fin = stack.enter_context(
            Probe(GBA.GlobalBA, "_sharded_full_ba"))
        probes_fin = program_probes(stack, gba_programs)
        trace.summary("run", False, draw_name())
        rematch = program_probes(stack, ("GlobalBA.rematch_intermediate",),
                                 EAGER_SITES)
        g1 = graph_counts()
        n0 = PF.LAUNCHES
        t0 = time.perf_counter()
        system.finalize()
        torch.cuda.synchronize()
        finalize_s = time.perf_counter() - t0
        finalize_launches = PF.LAUNCHES - n0
        trace.summary("final", False, draw_name())
    g_fin = graph_delta(g1)
    eager_host_s = dict(program_host_s(eager),
                        **program_host_s(rematch),
                        _verify_search_refine=[verify.seconds, verify.calls],
                        realign_intermediate_frames=[realign.seconds,
                                                     realign.calls],
                        _sharded_full_ba=[
                            sharded.seconds + sharded_fin.seconds,
                            sharded.calls + sharded_fin.calls])
    ate_final, _, _ = system.ate_against_gt(with_scale=False)
    kfs_final = system.map.n_keyframes
    tracking = run_launches - verify.launches
    parting = trace_parting("loop", trace.trace)
    name = "loop_lane" if n_devices == 1 else "loop_sharded"
    phase(name, frames=LOOP_FRAMES, window=LOOP_WINDOW, n_devices=n_devices,
          mesh=([str(d) for d in lc.gba._mesh.devices]
                if lc.gba._mesh is not None else None),
          tracked=tracked, keyframes=kfs, points=pts, ate_m=ate,
          loops_closed=loops, wall_s=wall, fps=tracked / wall,
          trace_s=trace.seconds, wall_s_without_trace=wall - trace.seconds,
          loop_correction_ms=correct_ms, finalize_s=finalize_s,
          keyframes_final=kfs_final, points_final=system.map.n_points,
          ate_final_m=ate_final, device_calls=runner.n_device_calls,
          graphs=g, pose_launches=dict(tracking=tracking,
                             verification=verify.launches,
                             realign=finalize_launches),
          verifications=verify.calls, realign_batch=realign.out,
          full_ba_calls=dict(run=full.calls, finalize=full_fin.calls),
          sharded_full_ba_calls=dict(run=sharded.calls,
                                     finalize=sharded_fin.calls),
          full_ba_s=dict(run=full.seconds, finalize=full_fin.seconds),
          backend=backend_counts(system), host_s_and_calls=host_s,
          program_host_s=program_host_s(probes),
          finalize_graphs=g_fin,
          finalize_program_host_s=program_host_s(probes_fin),
          eager_host_s=eager_host_s, memory=memory(),
          jax_cpu=JAX_LOOP if n_devices == 1 else JAX_LOOP_SHARDED,
          draw=draw_name(), loop_candidates=trace.trace["loops"],
          trace_parting=parting, card=card_line())
    J = JAX_LOOP if n_devices == 1 else JAX_LOOP_SHARDED
    check(tracked == J["tracked"], f"loop lane tracked {tracked} of 400")
    check(loops >= 1, "the loop lane closed no loop")
    check(abs(kfs - J["keyframes"]) <= 0.1 * J["keyframes"],
          f"loop lane {kfs} keyframes, the JAX run {J['keyframes']}")
    check(abs(kfs_final - J["keyframes_final"])
          <= 0.1 * J["keyframes_final"],
          f"loop lane {kfs_final} keyframes after finalize, the JAX run "
          f"{J['keyframes_final']}")
    check(ate <= LOOP_ATE_FACTOR * J["ate_m"],
          f"loop lane ATE {ate} m, the JAX run {J['ate_m']} m")
    check(ate_final <= LOOP_ATE_FACTOR * J["ate_final_m"],
          f"loop lane ATE {ate_final} m after finalize, the JAX run "
          f"{J['ate_final_m']} m")
    check(parting["jax"]["cycles_compared"] >= LOOP_TRACE_CYCLES,
          f"the {name}'s trace parts from the JAX trace at "
          f"{parting['jax']['parting']}")
    closed = [lp[1] for lp in trace.trace["loops"] if lp[5]]
    jax_closed = [lp[1] for lp in LT.load()["jax"]["loop"]["loops"] if lp[5]]
    check(closed[:1] == jax_closed[:1],
          f"the {name} closed onto keyframe frames {closed}, the JAX run's "
          f"{jax_closed}")
    check(verify.calls >= 1 and verify.launches == verify.calls,
          f"{verify.launches} pose launches for {verify.calls} loop "
          "verifications")
    check(tracking == 2 * LOOP_WINDOW * runner.n_device_calls,
          f"{tracking} tracking launches for {runner.n_device_calls} windows")
    check_one_replay_per_call(g, dict(window_track=runner.n_device_calls))
    check(realign.calls == 2 and finalize_launches == 2
          and all(b > 0 for b in realign.out),
          f"{finalize_launches} pose launches for the realign calls "
          f"{realign.out}")
    # every full BA of the run is a loop correction's, finalize makes three
    check(full.calls == len(correct_ms) and full_fin.calls == 3,
          f"{full.calls} full BAs for {len(correct_ms)} loop corrections, "
          f"{full_fin.calls} in finalize")
    # the keyframe back-end, loop closing and finalize ran their programs
    # as graphs; with n_devices > 1 every full BA is the sharded step's
    unsharded_full = ("gba_full_ba",) if n_devices == 1 else ()
    check_programs(name, g, probes, required=(
        "triangulate_pool", "fuse_pool", "fuse_search_single",
        "gba_point_ba", "gba_outliers", "pgo")
        + unsharded_full)
    check_programs(f"{name} finalize", g_fin, probes_fin,
                   required=("gba_outliers",) + unsharded_full)
    if n_devices == 1:
        check(sharded.calls == sharded_fin.calls == 0,
              "the unsharded loop lane ran the sharded step")
        check(probes["gba_full_ba"].calls == full.calls
              and probes_fin["gba_full_ba"].calls == full_fin.calls,
              "a full BA of the unsharded loop lane ran outside its program")
    else:
        check(lc.gba._mesh.size == n_devices,
              f"the loop closer's mesh has {lc.gba._mesh.size} shards")
        check(sharded.calls == full.calls
              and sharded_fin.calls == full_fin.calls,
              f"sharded full BAs {sharded.calls} + {sharded_fin.calls} for "
              f"{full.calls} + {full_fin.calls} full BAs")
        check(probes["gba_full_ba"].calls == probes_fin["gba_full_ba"].calls
              == 0, "the sharded loop lane ran the unsharded full BA")
        ratio = ate_final / unsharded["ate_final_m"]
        check(1 / LOOP_SHARDED_ATE_FACTOR <= ratio <= LOOP_SHARDED_ATE_FACTOR,
              f"sharded loop lane ATE {ate_final} m after finalize, the "
              f"unsharded run's {unsharded['ate_final_m']} m")
    return dict(launches=run_launches + finalize_launches,
                realign_args=realign_kernel.args,
                verify_args=verify_kernel.args, ate_final_m=ate_final,
                gba=lc.gba, problem=problem,
                kept={n: k.kept() for n, k in keep.items()})


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|, on the host."""
    a, b = a.cpu(), b.cpu()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-300)).item()


def multichip_phase(dev, lane) -> None:
    """The sharded BA step on the sharded loop lane's own whole-map problem
    (float64), on a 4-shard mesh of the card against a 1-shard mesh, the
    same 4 shards on the CPU and a rerun; ms per iteration and peak memory
    for 1 and 4 shards; the sharded matcher at the tracking shapes (4096
    local-map slots, 1024 features) against ``hamming_matrix``."""
    gba, problem = lane["gba"], lane["problem"]
    mesh = MC.make_mesh(MULTICHIP_SHARDS, dev)
    one = MC.make_mesh(1, dev)
    card = card_line()
    phase("mesh", devices=[str(d) for d in mesh.devices], size=mesh.size,
          distinct=mesh.distinct, device_count=torch.cuda.device_count(),
          card=card)
    C = problem.cam_pose.shape[0]
    P, M = problem.obs_cam.shape

    def solve(m, prob, cam, bf):
        step = MC.sharded_ba_step(m, cam, bf, n_iters=MULTICHIP_ITERS)
        return step(MC.shard_problem(prob, m))

    def timed(m):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = solve(m, problem, gba.cam64, gba.bf64)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = _wall_ms(lambda: solve(m, problem, gba.cam64, gba.bf64),
                      sync=True) / MULTICHIP_ITERS
        return out, ms, peak

    out4, ms4, peak4 = timed(mesh)
    out1, ms1, peak1 = timed(one)
    again = solve(mesh, problem, gba.cam64, gba.bf64)
    cpu_prob = BA.BAProblem(*(t.cpu() for t in problem))
    cpu_cam = Pinhole(*(c.cpu() for c in gba.cam64))
    t0 = time.perf_counter()
    cpu4 = solve(MC.make_mesh(MULTICHIP_SHARDS, "cpu"), cpu_prob, cpu_cam,
                 gba.bf64.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3 / MULTICHIP_ITERS
    err_one = [_rel_err(a, b) for a, b in zip(out4, out1)]
    err_cpu = [_rel_err(a, b) for a, b in zip(out4, cpu4)]
    rerun = all(torch.equal(a, b) for a, b in zip(out4, again))

    g = torch.Generator().manual_seed(0)
    pb = torch.randint(0, 2, (4096, 256), generator=g, dtype=torch.int8)
    fb = torch.randint(0, 2, (1024, 256), generator=g, dtype=torch.int8)
    pb, fb = pb.to(dev), fb.to(dev)
    d, idx = MC.sharded_hamming_topk(mesh)(pb, fb)
    H = hamming_matrix(pb, fb)
    match_exact = (torch.equal(d, H.amin(dim=1))
                   and torch.equal(idx, H.argmin(dim=1).to(torch.int32)))
    phase("multichip", shards=MULTICHIP_SHARDS, iterations=MULTICHIP_ITERS,
          dtype=str(problem.cam_pose.dtype),
          cam_slots=C, point_slots=P, obs_slots=M,
          keyframes=int(problem.cam_valid.sum()),
          points=int(problem.point_valid.sum()),
          ms_per_iter=dict(shards_4=ms4, shards_1=ms1, cpu_shards_4=cpu_ms),
          peak_mib=dict(shards_4=peak4 / 2**20, shards_1=peak1 / 2**20),
          rel_err_vs_1_shard=dict(cam=err_one[0], points=err_one[1]),
          rel_err_vs_cpu=dict(cam=err_cpu[0], points=err_cpu[1]),
          rerun_bit_identical=rerun, matcher_exact=match_exact, card=card)
    check(out4[0].device == mesh.devices[0] and out4[0].dtype ==
          torch.float64, "the sharded step's result is not float64 on the "
          "mesh's first device")
    check(all(torch.isfinite(t).all().item() for t in out4),
          "the sharded step gave non-finite values")
    check(max(err_one) <= MULTICHIP_RTOL,
          f"4 shards against 1: relative errors {err_one}")
    check(max(err_cpu) <= MULTICHIP_RTOL,
          f"4 shards on the card against the CPU: relative errors {err_cpu}")
    check(rerun, "the sharded step's rerun is not bit-identical")
    check(match_exact, "the sharded matcher differs from hamming_matrix")


def dryrun_phase(dev) -> None:
    t0 = time.perf_counter()
    dryrun_multichip(MULTICHIP_SHARDS)
    torch.cuda.synchronize()
    phase("dryrun_multichip", shards=MULTICHIP_SHARDS,
          seconds=time.perf_counter() - t0, card=card_line())


def entry_phase(dev) -> None:
    """``entry()``'s fine-tracking step on the card against the same step
    on the CPU."""
    fn, args = entry()
    check(args[0].position.device.type == "cuda",
          "entry() did not default to the card")
    T, n_inl = fn(*args)
    cfn, cargs = entry("cpu")
    cT, cn = cfn(*cargs)
    err = (T.cpu() - cT).abs().max().item()
    # the projection match behind it: the same map points in view
    visible = int(TS.fine_step(*args)["visible"].sum())
    visible_cpu = int(TS.fine_step(*cargs)["visible"].sum())
    ms = _wall_ms(lambda: fn(*args), sync=True)
    phase("entry", n_inliers=int(n_inl), n_inliers_cpu=int(cn),
          visible=visible, visible_cpu=visible_cpu, max_abs_err=err, ms=ms,
          card=card_line())
    check(int(n_inl) == int(cn),
          f"entry(): {int(n_inl)} inliers on the card, {int(cn)} on the CPU")
    check(visible == visible_cpu > 0,
          f"entry(): {visible} points in view on the card, {visible_cpu} "
          "on the CPU")
    check(err <= POSE_ATOL, f"entry(): T differs from the CPU's by {err}")


def multichip_phases(dev, unsharded) -> dict:
    """The sharded loop lane, the sharded step on its problem, the dry run
    and the entry point.  Returns the sharded lane's results."""
    lane = loop_lane_phase(dev, MULTICHIP_SHARDS, unsharded)
    multichip_phase(dev, lane)
    dryrun_phase(dev)
    entry_phase(dev)
    return lane


def plain_spread(args, kw, trials: int = 16) -> float:
    """How far the plain version's pose moves when its points change by
    one float32 ulp: the max over ``trials`` seeded random 1-ulp
    perturbations (one problem, batched as (1, ...))."""
    T, _, _ = PF.pose_refine_fused_reference(*args, **kw)
    gen = torch.Generator(device=args[1].device).manual_seed(0)
    spread = 0.0
    for _ in range(trials):
        ulp = (torch.rand(args[1].shape, generator=gen,
                          device=args[1].device) - 0.5) * 2.4e-7
        Tp, _, _ = PF.pose_refine_fused_reference(
            args[0], args[1] * (1 + ulp), *args[2:], **kw)
        spread = max(spread, (Tp - T).abs().max().item())
    return spread


def pose_batched_phase(dev, lane) -> None:
    """The pose kernel on the loop lane's own inputs: the realign's batched
    launch and a loop verification's single one (``pose_cases_phase``)."""
    pose_cases_phase("pose_batched",
                     (("realign", lane["realign_args"]),
                      ("verification", lane["verify_args"])))


def pose_mono_phase(dev, lane) -> dict:
    """The pose kernel on the mono-VI lane's own inputs, every row mono: a
    window's coarse (1 x 3) and fine (2 x 2) problem after the
    visual-inertial initialization and the realign's batched launch.
    Returns the fine problem's device and bound microseconds."""
    cases = (("coarse", lane["coarse_args"]), ("fine", lane["fine_args"]),
             ("realign", lane["realign_args"]))
    for name, (a, _) in cases:
        check(bool((a[3] <= 0).all()),
              f"mono-VI lane's {name} problem has stereo rows")
    return pose_cases_phase("pose_mono", cases, mono=True)["fine"]


def pose_cases_phase(phase_name: str, cases, mono: bool = False) -> dict:
    """The pose kernel on captured calls ``(name, (args, kwargs))``, against
    the plain version, reruns bit-identical, timed beside the bound.
    Returns {name: dict(device_us, bound_us)}.

    Problems the two solve alike (the same inlier set, >= 10 inliers:
    what the realign keeps) are held within POSE_BATCHED_ATOL.  The others
    (a chi2 threshold flipped between the two, or a start far from the
    answer) may differ more only where the plain version is chaotic
    itself: 1-ulp changes of its points move its own pose at least half as
    far (on the loop lane one frame ends with 0 to 202 inliers in the
    plain version alone).  At most 2% of a batch may be such problems."""
    timing = {}
    for name, (a, kw) in cases:
        T0, pts = a[0], a[1]
        batched = T0.dim() == 3
        if not batched:
            a = tuple(t[None] for t in a[:6]) + tuple(a[6:])
        B, N = pts.shape[0] if batched else 1, pts.shape[-2]
        outer, inner = kw["outer_iters"], kw["inner_iters"]
        T, inl, cnt = PF.pose_refine_fused(*a, **kw)
        T2, inl2, cnt2 = PF.pose_refine_fused(*a, **kw)
        Tr, ir, nr = PF.pose_refine_fused_reference(*a, **kw)
        torch.cuda.synchronize()
        check(torch.equal(T, T2) and torch.equal(inl, inl2)
              and torch.equal(cnt, cnt2),
              f"batched pose kernel rerun not bit-identical ({name})")
        per = (T - Tr).abs().amax(dim=(1, 2))
        kept = (nr >= 10) & (inl == ir).all(dim=-1)
        err_kept = per[kept].max().item() if bool(kept.any()) else 0.0
        flipped = torch.nonzero(~kept & (per > POSE_ATOL))[:, 0]
        spreads = {b: plain_spread([t[b:b + 1] for t in a[:6]]
                                   + list(a[6:]), kw)
                   for b in flipped.tolist()}
        # each problem alone through the kernel: the batched launch must
        # give the same bits as single ones
        single_same = all(
            torch.equal(PF.pose_refine_fused(
                *[t[b:b + 1] for t in a[:6]], *a[6:], **kw)[0][0], T[b])
            for b in sorted({0, B - 1, int(per.argmax())}))
        agree = (inl == ir).float().mean().item()
        dcnt = (cnt - nr)[kept].abs().max().item() if bool(kept.any()) \
            else 0
        call_us = time_calls_us(lambda: PF.pose_refine_fused(*a, **kw), n=50)
        device_us = graph_us(lambda: PF.pose_refine_fused(*a, **kw), k=20)
        plain_us = time_calls_us(
            lambda: PF.pose_refine_fused_reference(*a, **kw), n=10, warmup=2)
        b_ms, b_by = pose_bound(N, outer, inner, batch=B, mono=mono)
        timing[name] = dict(device_us=device_us, bound_us=b_ms * 1e3)
        phase(phase_name, case=name, B=B, N=N, iters=[outer, inner],
              matched=int(a[5].sum()),
              max_abs_err=per.max().item(), max_abs_err_kept=err_kept,
              kept=int(kept.sum()), inlier_agreement=agree,
              err_quantiles=torch.quantile(
                  per, torch.tensor([0.5, 0.9, 0.99], device=per.device)
              ).tolist(),
              flipped={b: dict(err=per[b].item(), count=int(cnt[b]),
                               plain_count=int(nr[b]), plain_spread=sp)
                       for b, sp in spreads.items()},
              batched_equals_single=single_same,
              max_count_diff_kept=dcnt, call_us=call_us,
              device_us=device_us, device_us_per_problem=device_us / B,
              plain_us=plain_us, bound_us=b_ms * 1e3, bound_by=b_by)
        check(err_kept <= POSE_BATCHED_ATOL,
              f"batched pose error {err_kept} on kept problems ({name})")
        for b, sp in spreads.items():
            check(per[b].item() <= 2.0 * sp,
                  f"pose problem {b} differs by {per[b].item()}, the plain "
                  f"version's own 1-ulp spread is {sp} ({name})")
        check(len(flipped) <= max(1, B // 50),
              f"{len(flipped)} of {B} problems flipped ({name})")
        check(single_same, f"batched launch differs from single ({name})")
        check(agree > 0.99, f"inlier agreement {agree} ({name})")
        check(dcnt <= max(3, N // 100), f"inlier counts differ by {dcnt}")
    return timing


# the shapes the lanes draw at: the mono initializer's essential (256
# hypotheses) and homography (128) draws over a 2048-slot match bucket,
# and 512 x 1024 (the relocalizer's PnP over a 1024-row bucket)
PRNG_SHAPES = ((256, 2048), (128, 1024), (512, 1024))


def draw_name() -> str:
    """The RANSACs' draw dtype now (``prng.x64``: float64 where the lane's
    JAX reference ran with ``jax_enable_x64``)."""
    return str(prng.draw_dtype()).replace("torch.", "")


def prng_phase(dev) -> None:
    """The threefry draws on the card against the CPU's at the lanes'
    shapes: 32- and 64-bit words, float32 and float64 uniforms (minval
    1e-9, the RANSACs' draw) bit for bit, and the sample indices of both
    dtypes equal; the card's draws under
    ``torch.cuda.set_sync_debug_mode("error")``; ms of one card draw."""
    key = prng.split(prng.PRNGKey(7))[1]
    rows = []
    for H, N in PRNG_SHAPES:
        mask = torch.arange(N) < 3 * N // 4          # a padded tail

        def draws(m):
            d = m.device
            out = [prng.random_bits(key, (H, N), 32, d),
                   prng.random_bits(key, (H, N), 64, d)]
            for dt in (torch.float32, torch.float64):
                out += [prng.uniform(key, (H, N), dt, 1e-9, 1.0, d),
                        prng.sample_without_replacement(key, m, H, 8, dt)]
            return out

        cpu = [t.numpy() for t in draws(mask)]
        mask_dev = mask.to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card = draws(mask_dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        card = [t.cpu().numpy() for t in card]
        same = [_same_bits([x], [y]) for x, y in zip(cpu, card)]
        ms = {str(dt).replace("torch.", ""): _wall_ms(
            lambda dt=dt: prng.sample_without_replacement(
                key, mask_dev, H, 8, dt), True)
            for dt in (torch.float32, torch.float64)}
        rows.append(dict(shape=[H, N], bits32=same[0], bits64=same[1],
                         uniform_f32=same[2], samples_f32=same[3],
                         uniform_f64=same[4], samples_f64=same[5],
                         sample_ms=ms))
        check(all(same), f"threefry draws at {H} x {N}: card against CPU "
              f"{same}")
    phase("prng", key=[int(k) for k in key], draws=rows, card=card_line())


def trace_parting(lane: str, trace: dict) -> dict:
    """Where the card's trace of ``lane`` first parts from the committed
    traces (``utils/lane_trace.py``): the JAX package's and the port's
    CPU run's, with the largest keyframe-centre difference up to there.
    Printed, not gated; a missing or unreadable trace raises."""
    ref = LT.load()
    return {group: LT.first_parting(trace, ref[group][lane])
            for group in ("jax", "port_cpu")}


def loop_cpu_gpu_phase(dev) -> None:
    """The drifted ring closed on the CPU and on the card; then the
    card's pose-graph solve and Sim3 RANSAC of that closure rerun under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    base, s, _, _ = LP.build_ring()
    new_side, truth = LP.drift_newest(base)
    voc = SLAM.load_vocabulary(s)
    out = {}
    for d in ("cpu", dev):
        m = LP.clone_map(base)
        lc = LC.LoopClosing(s, m, KeyframeDatabase(voc, m), d,
                            gba=GBA.GlobalBA(s, m, d))
        for k in m.valid_keyframes():
            lc.db.add(int(k))
        with Probe(LC, "solve_pgo", keep=True) as pgo, \
                Probe(LC, "sim3_ransac") as rs:
            t0 = time.perf_counter()
            for k in new_side:
                lc.process(k)
            if d != "cpu":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        out[str(d)] = (lc, m, pgo, rs, ms)
    (lcc, mc, _, _, ms_c), (lcg, mg, pgo, rs, ms_g) = out["cpu"], out[str(dev)]
    kfs = mc.valid_keyframes()
    cc = np.linalg.inv(mc.kf_pose[kfs])[:, :3, 3]
    cg = np.linalg.inv(mg.kf_pose[kfs])[:, :3, 3]
    diff = float(np.linalg.norm(cc - cg, axis=1).max())
    drift_err = max(float(np.linalg.norm(
        np.linalg.inv(mg.kf_pose[k])[:3, 3] - np.linalg.inv(truth[k])[:3, 3]))
        for k in new_side)
    # the closure's PGO and RANSAC again, with any host sync an error
    (graph,), pgo_kw = pgo.args
    (src, dst, mask, sample_idx), rs_kw = rs.args[0][:4], rs.args[1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = [PGO.solve_pgo(graph, **pgo_kw) for _ in range(2)]
        # with the sample indices the closure drew
        SIM3.sim3_ransac(src, dst, mask, sample_idx, **rs_kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for a in again for x, y in zip(a, pgo.out[0]))
    pgo_ms = time_calls_us(lambda: PGO.solve_pgo(graph, **pgo_kw), n=5,
                           warmup=1) / 1e3
    phase("loop_cpu_vs_gpu", draw=draw_name(), keyframes=int(len(kfs)),
          vertices=int(graph.poses.shape[0]),
          edges=int(graph.edge_i.shape[0]),
          loops_cpu=lcc.n_loops_closed, loops_gpu=lcg.n_loops_closed,
          max_centre_diff_m=diff, max_drift_error_m=drift_err,
          process_ms_cpu=ms_c, process_ms_gpu=ms_g, pgo_ms=pgo_ms,
          pgo_rerun_bit_identical=same)
    check(lcg.n_loops_closed == lcc.n_loops_closed >= 1,
          f"loops closed: GPU {lcg.n_loops_closed}, CPU {lcc.n_loops_closed}")
    check(np.array_equal(mg.valid_keyframes(), kfs),
          "CPU and GPU keep different keyframes")
    check(diff <= RING_CENTRE_ATOL, f"keyframe centres differ by {diff} m")
    check(drift_err < 0.05, f"drifted keyframes left {drift_err} m off")
    check(same, "solve_pgo reruns not bit-identical on the card")


class CapturePose:
    """While installed, keeps the arguments of the last pose-kernel call
    ``module.pose_refine_fused`` made with each (outer, inner) schedule,
    from the moment ``armed()`` is true."""

    def __init__(self, module, armed):
        self.module, self.armed = module, armed
        self.inner = module.pose_refine_fused
        self.last = {}

    def __enter__(self):
        def wrapped(*a, **k):
            if self.armed():
                self.last[(k["outer_iters"], k["inner_iters"])] = (a, k)
            return self.inner(*a, **k)
        self.module.pose_refine_fused = wrapped
        return self

    def __exit__(self, *exc):
        self.module.pose_refine_fused = self.inner


def vi_summary(system) -> dict:
    sol = system.imu_solver
    ate, scale, _ = system.ate_against_gt(with_scale=True)
    return dict(tracked=len(system.tracker.trajectory),
                keyframes=int(system.map.n_keyframes),
                points=int(system.map.n_points), sim3_ate_m=float(ate),
                align_scale=float(scale),
                vi_initialized=bool(sol.gyro_initialized
                                    and sol.gravity_initialized),
                stage=sol.stage.name,
                bg_err=float(np.abs(sol.bg - VP.BG_TRUE).max()),
                init_scale=float(sol.init_scale),
                map_transforms=int(getattr(system.map, "n_transforms", 0)))


def mono_vi_lane_phase(dev) -> dict:
    system, frames = VP.build_lane(dev)
    runner = WindowedRunner(system, window=VP.WINDOW, two_stage=True)
    sol = system.imu_solver
    timed = [Probe(WindowedRunner, "_dispatch"),
             Probe(WindowedRunner, "_consume"),
             Probe(WindowedRunner, "_local_map"),
             Probe(WIN._InFlight, "fetch"),
             Probe(SlamSystem, "process_frame"),
             Probe(MI.MonoInitializer, "try_initialize"),
             Probe(LM.LocalMapper, "dispatch_deferred"),
             Probe(LM.LocalMapper, "commit_deferred"),
             Probe(LM.LocalMapper, "process_sync"),
             Probe(VIS.ImuStateSolver, "update_map"),
             Probe(VIS.ImuStateSolver, "_stage_gravity_scale"),
             Probe(VIS.ImuStateSolver, "_stage_refine")]
    vi_programs = ("imu_chain_solve", "gba_full_ba", "gba_point_ba",
                   "gba_outliers")
    with contextlib.ExitStack() as stack:
        for t in timed:
            stack.enter_context(t)
        # a window's inputs once gravity and scale are in
        kept = stack.enter_context(KeepInputs(
            WIN, "window_track", dev, armed=lambda: sol.gravity_initialized))
        probes = program_probes(stack, vi_programs)
        eager = program_probes(stack, ("solve_scale_gravity",
                                       "knn2_ratio_match", "_gather_points"),
                               EAGER_SITES)
        # each initialization attempt's two-view geometry, for
        # two_view_phase
        two_view = []
        stack.enter_context(Probe(MI, "essential_ransac", after=lambda a, k:
                                  two_view.append(dict(essential=(a, k)))))
        for name in ("homography_ransac", "recover_pose_from_essential"):
            stack.enter_context(Probe(
                MI, name, after=lambda a, k, name=name:
                two_view[-1].__setitem__(name, (a, k))))
        # float64 draws, as the JAX reference's (it runs with x64 on); the
        # trace holds the landings and each keyframe cycle
        stack.enter_context(prng.x64(True))
        draw = draw_name()
        trace = stack.enter_context(LT.LaneTrace(system, MI, LC))
        g0 = graph_counts()
        PF.LAUNCHES = 0
        t0 = time.perf_counter()
        runner.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = PF.LAUNCHES
    g = graph_delta(g0)
    host_s = {f"{t.owner.__name__}.{t.name}": [t.seconds, t.calls]
              for t in timed}
    # that window again, eagerly, for the pose problems its replay solved
    prog, (a, k) = kept.kept()
    with graphs.disabled(), CapturePose(WS, lambda: True) as window:
        prog(*a, **k)
    before = vi_summary(system)
    trace.summary("run", True, draw)
    final_probes = [Probe(VIS.ImuStateSolver, "_solve_chain"),
                    Probe(GBA.GlobalBA, "full_ba")]
    with contextlib.ExitStack() as stack:
        keep = {n: stack.enter_context(KeepInputs(*PROGRAM_SITES[n], dev,
                                                  nth=1))
                for n in ("imu_chain_solve", "gba_full_ba", "gba_outliers")}
        for t in final_probes:
            stack.enter_context(t)
        realign = stack.enter_context(
            Probe(GBA.GlobalBA, "realign_intermediate_frames", keep=True))
        realign_kernel = stack.enter_context(Probe(GBA, "pose_refine_fused"))
        probes_fin = program_probes(stack, vi_programs)
        g1 = graph_counts()
        n0 = PF.LAUNCHES
        t0 = time.perf_counter()
        system.finalize()
        torch.cuda.synchronize()
        finalize_s = time.perf_counter() - t0
        finalize_launches = PF.LAUNCHES - n0
    g_fin = graph_delta(g1)
    after = vi_summary(system)
    trace.summary("final", True, draw)
    tracked = before["tracked"]
    phase("mono_vi_lane", frames=len(frames), window=VP.WINDOW, **before,
          landed=trace.trace["landed"], draw=draw,
          mono_init_trace=trace.trace["attempts"],
          trace_parting=trace_parting("mono_vi", trace.trace),
          chain_restarts=runner.n_chain_restarts,
          device_calls=runner.n_device_calls, depth=runner.depth,
          graphs=g, wall_s=wall, fps=tracked / wall, trace_s=trace.seconds,
          wall_s_without_trace=wall - trace.seconds, finalize_s=finalize_s,
          final={k: after[k] for k in ("keyframes", "points", "sim3_ate_m",
                                       "align_scale", "bg_err", "stage")},
          pose_launches=dict(tracking=run_launches,
                             realign=finalize_launches),
          realign_batch=realign.out, mono_init_attempts=(
              system.tracker.mono_initializer.n_attempts),
          backend=backend_counts(system), host_s_and_calls=host_s,
          finalize_host_s_and_calls={
              f"{t.owner.__name__}.{t.name}": [t.seconds, t.calls]
              for t in final_probes},
          program_host_s=program_host_s(probes), finalize_graphs=g_fin,
          finalize_program_host_s=program_host_s(probes_fin),
          eager_host_s=program_host_s(eager), memory=memory(),
          jax_cpu=JAX_MONO_VI)
    J = JAX_MONO_VI
    check(before["vi_initialized"], "the mono-VI lane never initialized its "
          f"IMU state (stage {before['stage']})")
    check(before["bg_err"] < 5e-3 and after["bg_err"] < 5e-3,
          f"gyro bias off by {before['bg_err']}, {after['bg_err']} after "
          "finalize")
    check(tracked == J["tracked"],
          f"mono-VI lane tracked {tracked}, the JAX run {J['tracked']}")
    check(before["keyframes"] == J["keyframes"]
          and after["keyframes"] == J["keyframes_final"],
          f"mono-VI lane {before['keyframes']} / {after['keyframes']} "
          f"keyframes, the JAX run {J['keyframes']} / "
          f"{J['keyframes_final']}")
    check(trace.trace["landed"] == J["landed"],
          f"mono-VI lane landed {trace.trace['landed']}, the JAX run "
          f"{J['landed']}")
    check(abs(before["points"] - J["points"])
          <= MONO_VI_POINTS_RTOL * J["points"],
          f"mono-VI lane {before['points']} points, the JAX run "
          f"{J['points']}")
    for r, ate_ref in ((before, J["sim3_ate_m"]),
                       (after, J["sim3_ate_final_m"])):
        check(abs(r["align_scale"] - 1.0) < 0.05,
              f"mono-VI lane alignment scale {r['align_scale']}")
        check(abs(r["sim3_ate_m"] - ate_ref) <= MONO_VI_ATE_RTOL * ate_ref,
              f"mono-VI lane Sim3 ATE {r['sim3_ate_m']} m, the JAX run "
              f"{ate_ref} m")
    check(before["map_transforms"] >= 1
          and runner.n_chain_restarts == before["map_transforms"],
          f"{runner.n_chain_restarts} chain restarts for "
          f"{before['map_transforms']} map transforms")
    check(run_launches == 2 * VP.WINDOW * runner.n_device_calls,
          f"{run_launches} tracking launches for {runner.n_device_calls} "
          "windows")
    check_one_replay_per_call(g, dict(window_track=runner.n_device_calls))
    check(realign.calls == 2 and finalize_launches == 2
          and all(b > 0 for b in realign.out),
          f"{finalize_launches} pose launches for the realign calls "
          f"{realign.out}")
    check((1, 3) in window.last and (2, 2) in window.last,
          "no window was tracked after the visual-inertial initialization")
    # the chain solves and the global-BA passes ran as graphs
    check_programs("mono_vi_lane", g, probes)
    check_programs("mono_vi_lane finalize", g_fin, probes_fin,
                   required=("imu_chain_solve", "gba_full_ba",
                             "gba_outliers"))
    two_view_phase(dev, two_view)
    return dict(launches=run_launches + finalize_launches,
                coarse_args=window.last[(1, 3)],
                fine_args=window.last[(2, 2)],
                realign_args=realign_kernel.args,
                kept={n: k.kept() for n, k in keep.items()})


def two_view_phase(dev, attempts: list) -> None:
    """The mono-VI lane's initialization attempts' two-view geometry again,
    on the host, where the initializer runs it, and on the card: the
    points and the mask uploaded, the essential RANSAC, then the homography
    RANSAC and the pose recovery where the lane reached them, each count
    and the pose read back.  Host seconds of each attempt (the card's after
    one untimed pass that loads its libraries) and the inlier counts of
    each; printed, not gated (the batched float32 ``eigh`` of the 8-point
    normal matrices is ill-conditioned: the card's scores its hypotheses
    otherwise; PERF.md section 6)."""

    def run(attempt, d):
        uploaded = {}

        def on(x):
            if not isinstance(x, torch.Tensor):
                return x
            if id(x) not in uploaded:
                uploaded[id(x)] = x.to(d)
            return uploaded[id(x)]

        a, k = attempt["essential"]
        t0 = time.perf_counter()
        E, inl, n_e = MI.essential_ransac(*map(on, a), **k)
        counts = [int(n_e), None]
        if "homography_ransac" in attempt:
            a, k = attempt["homography_ransac"]
            counts[1] = int(MI.homography_ransac(*map(on, a), **k)[2])
        if "recover_pose_from_essential" in attempt:
            a, k = attempt["recover_pose_from_essential"]
            [x.cpu() for x in MI.recover_pose_from_essential(
                E, on(a[1]), on(a[2]), inl, **k)]
        return time.perf_counter() - t0, counts

    rows = []
    with prng.x64(True):
        run(attempts[0], dev)
        for attempt in attempts:
            (host_s, host_n), (card_s, card_n) = (run(attempt, "cpu"),
                                                  run(attempt, dev))
            rows.append(dict(host_s=host_s, card_s=card_s,
                             inliers_host=host_n, inliers_card=card_n))
    phase("mono_init_two_view", draw="float64", attempts=rows,
          host_s=sum(r["host_s"] for r in rows),
          card_s=sum(r["card_s"] for r in rows), card=card_line())


def _wall_ms(fn, sync: bool, n: int = 5) -> float:
    """Median milliseconds the caller waits for ``fn()`` (with ``sync`` the
    card is synchronized inside the interval: the callers read the result
    on the host at once)."""
    times = []
    for _ in range(n + 1):
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def vi_solvers_phase(dev) -> None:
    """``solve_scale_gravity`` and ``solve_imu_chain`` (float64) at K = 16
    and 64 keyframe slots, on the CPU and on the card."""
    for K, n_kf in ((16, 12), (64, 60)):
        arrays = VP.chain_arrays(n_kf, K)
        arrays.pop("v_true")
        out, ms = {}, {}
        for d in ("cpu", dev):
            t = {k: torch.from_numpy(np.ascontiguousarray(
                a if a.dtype == bool else a.astype(np.float64))).to(d)
                for k, a in arrays.items()}
            chain = IMU.ImuChain(**t)
            vec = lambda *x: torch.tensor(x, dtype=torch.float64, device=d)
            g0 = vec(0.3, -0.2, -9.71)
            trip = torch.arange(K - 2, device=d) < n_kf - 2

            def scale_gravity():
                return IMU.solve_scale_gravity(
                    t["R"], t["p"], t["dt"][:-1], t["dt"][1:], t["dp"][:-1],
                    t["dp"][1:], t["dv"][:-1], trip)

            def chain_solve():
                return IMU.solve_imu_chain(
                    chain, vec(0, 0, 0), vec(0, 0, 0), g0, vec(1.2)[0],
                    solve_scale=True, iterations=4, prior_bias_weight=10.0)

            sg, ch = scale_gravity(), chain_solve()
            out[str(d)] = (torch.cat([sg[0][None], sg[1], sg[3][None]]).cpu(),
                           torch.cat([ch["v"].reshape(-1), ch["bg"], ch["ba"],
                                      ch["g"], ch["s"][None]]).cpu())
            sync = d != "cpu"
            ms[str(d)] = dict(scale_gravity=_wall_ms(scale_gravity, sync),
                              imu_chain=_wall_ms(chain_solve, sync))
        (sg_c, ch_c), (sg_g, ch_g) = out["cpu"], out[str(dev)]
        d_sg = (sg_c - sg_g).abs().max().item()
        d_ch = (ch_c - ch_g).abs().max().item()
        phase("vi_solvers", K=K, keyframes=n_kf, state=3 * K + 9,
              scale=sg_g[0].item(), chain_scale=ch_g[-1].item(),
              max_diff_scale_gravity=d_sg, max_diff_imu_chain=d_ch,
              cpu_ms=ms["cpu"], gpu_ms=ms[str(dev)])
        check(abs(sg_g[0].item() - 2.0) < 0.1 and
              abs(ch_g[-1].item() - 2.0) < 0.1,
              f"IMU solvers miss the scale at K={K}")
        check(d_sg <= VI_SOLVER_ATOL,
              f"solve_scale_gravity differs by {d_sg} at K={K}")
        check(d_ch <= VI_SOLVER_ATOL,
              f"solve_imu_chain differs by {d_ch} at K={K}")


def mono_vi_cpu_gpu_phase(dev) -> None:
    """The small mono-VI configuration on the CPU and on the card, each
    drawing its own RANSAC hypotheses (float64, as the small trace's)."""
    out = {}
    for d in ("cpu", dev):
        system, frames = VP.build_lane(
            d, **dict(VP.SMALL, n_frames=MONO_VI_SMALL_FRAMES))
        runner = WindowedRunner(system, window=VP.SMALL_WINDOW)
        # the initializer's host seconds with the libraries warm (the
        # mono-VI lane before this phase paid their start-up)
        with Probe(MI.MonoInitializer, "try_initialize") as init, \
                prng.x64(True), LT.LaneTrace(system, MI, LC) as trace:
            t0 = time.perf_counter()
            runner.run(frames)
            if d != "cpu":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            trace.summary("run", True, draw_name())
        out[str(d)] = (system, trace.trace["landed"], runner, wall,
                       init.seconds, trace.trace, trace.seconds)
    ((sc, lc, rc, wall_c, init_c, tc, trace_c),
     (sg, lg, rg, wall_g, init_g, tg, trace_g)) = out["cpu"], out[str(dev)]
    ref = LT.load()
    a, b = vi_summary(sc), vi_summary(sg)

    def centres(system):
        m = system.map
        return {int(m.kf_frame_id[k]): np.linalg.inv(m.kf_pose[k])[:3, 3]
                for k in m.valid_keyframes()}

    cc, cg = centres(sc), centres(sg)
    diff = max(float(np.linalg.norm(cc[f] - cg[f])) for f in cc if f in cg)
    d_bg = float(np.abs(sc.imu_solver.bg - sg.imu_solver.bg).max())
    phase("mono_vi_cpu_vs_gpu", frames=MONO_VI_SMALL_FRAMES,
          window=VP.SMALL_WINDOW, cpu=a, gpu=b, landed_cpu=lc,
          landed_gpu=lg, keyframe_frames_cpu=sorted(cc),
          keyframe_frames_gpu=sorted(cg), max_centre_diff_m=diff,
          bg_diff=d_bg, wall_s_cpu=wall_c, wall_s_gpu=wall_g,
          trace_s_cpu=trace_c, trace_s_gpu=trace_g,
          mono_init_s_cpu=init_c, mono_init_s_gpu=init_g,
          windows_cpu=rc.n_device_calls, windows_gpu=rg.n_device_calls,
          draw="float64", mono_init_gpu=tg["attempts"],
          trace_parting=dict(
              cpu=LT.first_parting(tg, tc),
              committed_port_cpu=LT.first_parting(
                  tg, ref["port_cpu"]["mono_vi_small"]),
              committed_jax=LT.first_parting(
                  tg, ref["jax"]["mono_vi_small"])))
    check(a["vi_initialized"] and b["vi_initialized"],
          "mono-VI CPU vs GPU: a run never initialized its IMU state")
    check(lc == lg, f"stages landed at {lc} on the CPU, {lg} on the card")
    check(sorted(cc) == sorted(cg), "CPU and GPU keep different keyframes")
    check(a["tracked"] == b["tracked"],
          f"tracked {a['tracked']} on the CPU, {b['tracked']} on the card")
    check(diff <= MONO_VI_CENTRE_ATOL,
          f"mono-VI keyframe centres differ by {diff} m")
    check(d_bg <= MONO_VI_BG_ATOL, f"mono-VI gyro bias differs by {d_bg}")


# ---------------------------------------------------------------------------
# the dataset CLI lane: a rendered TUM-RGBD sequence through
# ``python -m snakeslam_tpu_torch``
# ---------------------------------------------------------------------------



def tum_render_phase(root: Path) -> dict:
    """The lane's sequence written in the TUM-RGBD layout (host seconds),
    then three of its frames decoded by the port's reader and held against
    the rendered arrays."""
    world = TF.lane_world()
    traj = TF.lane_trajectory(CLI_FRAMES)
    t0 = time.perf_counter()
    info = TF.write_tum_fixture(root, world, traj)
    seconds = time.perf_counter() - t0
    ds = TumRgbdDataset(root)
    check(len(ds) == CLI_FRAMES, f"the reader sees {len(ds)} frames")
    frames = list(ds)
    for i in (0, CLI_FRAMES // 2, CLI_FRAMES - 1):
        gray, z = render_frame(world, traj[i][1], with_depth=True)
        check(np.array_equal(frames[i].gray,
                             np.clip(gray, 0, 255).astype(np.uint8)),
              f"frame {i}: the decoded image is not the rendered one")
        check(np.array_equal(
            frames[i].depth,
            np.round(z * TF.DEPTH_PER_M).astype(np.uint16).astype(np.float64)
            * TumRgbdDataset.DEPTH_SCALE),
            f"frame {i}: the decoded depth is not the rendered one")
    phase("tum_render", image="640x480 uint8 gray + uint16 depth (5000 per "
          "m) PNGs", seconds=seconds, **info)
    return dict(root=root, traj=traj, depths=[f.depth for f in frames],
                grays={i: frames[i].gray
                       for i in (0, CLI_FRAMES // 2, CLI_FRAMES - 1)})


def cli_run(ini: Path, data: Path, out: Path, dev) -> dict:
    """``snakeslam_tpu_torch.__main__.main`` in-process on the card, with the
    launch counters set to 0 just before and read just after, and the host
    seconds of its stages."""
    from snakeslam_tpu_torch.__main__ import main as cli_main

    with_depth = []     # features with depth, per frame

    def count_depth(a, k):
        with_depth.append(int((a[1].depth > 0).sum()))

    stages = dict(orb=Probe(FeatureDetector, "detect"),
                  undistort=Probe(Preprocess, "undistort_keypoints"),
                  depth=Probe(Preprocess, "depth_from_rgbd",
                              after=count_depth),
                  tracking=Probe(SlamSystem, "process_frame"),
                  keyframe_cycles=Probe(LM.LocalMapper, "process_deferred"),
                  finalize=Probe(SlamSystem, "finalize"),
                  run=Probe(SlamSystem, "run"))
    # keyframe culls by the number of frames tracked before each (a cull
    # while frame i is tracked counts at i; one in finalize at the run's
    # length), as scripts/jax_cli_reference.py counts the JAX run's
    culls = collections.Counter()
    text = io.StringIO()
    with contextlib.ExitStack() as stack:
        for pr in stages.values():
            stack.enter_context(pr)
        stack.enter_context(Probe(
            SIMP.Simplification, "_erase",
            after=lambda a, k: culls.update([stages["tracking"].calls])))
        realign = stack.enter_context(Probe(GBA.GlobalBA,
                                            "realign_intermediate_frames"))
        realign_kernel = stack.enter_context(Probe(GBA, "pose_refine_fused"))
        verify = stack.enter_context(Probe(LC, "pose_refine_fused"))
        probes = program_probes(stack, [n for n in PROGRAM_SITES if n not in (
            "stereo_frontend", "imu_chain_solve")])
        stack.enter_context(contextlib.redirect_stdout(text))
        g0 = graph_counts()
        OK.FAST_LAUNCHES = 0
        PF.LAUNCHES = 0
        rc = cli_main([str(ini), "--dataset", str(data), "--outDir",
                       str(out), "--device", str(dev)])
        torch.cuda.synchronize()
        fast, pose = OK.FAST_LAUNCHES, PF.LAUNCHES
        g = graph_delta(g0)
    check(rc == 0, f"the CLI returned {rc}")
    check_programs("cli", g, probes, required=("orb",))
    check(probes["orb"].calls == stages["orb"].calls,
          f"{probes['orb'].calls} ORB programs for {stages['orb'].calls} "
          "detections")
    system = stages["finalize"].args[0][0]
    tracked = len(system.tracker.trajectory)
    ate, n = TF.ate_against_groundtruth(out / "trajectory_frames_ba.tum",
                                        data / "groundtruth.txt")
    wall = stages["run"].seconds - stages["finalize"].seconds
    host_s = {k: [pr.seconds, pr.calls] for k, pr in stages.items()}
    files = sorted(x.name for x in out.iterdir())
    return dict(system=system, tracked=tracked,
                keyframes=system.map.n_keyframes,
                points=system.map.n_points, ate_m=ate, ate_matched=n,
                wall_s=wall, fps=tracked / wall,
                finalize_s=stages["finalize"].seconds, host_s=host_s,
                program_host_s=program_host_s(probes),
                graphs=g, fast=fast, pose=pose, realign_calls=realign.calls,
                realign_launches=realign.launches,
                realign_args=realign_kernel.args,
                verification_launches=verify.launches,
                lba_runs=system.lba.n_runs, files=files,
                culls_at_frame=dict(sorted(culls.items())),
                features_with_depth=dict(mean=float(np.mean(with_depth)),
                                         min=int(np.min(with_depth))),
                cli_lines=text.getvalue().splitlines()[:2])


def check_cli_counts(name: str, r: dict):
    check(r["fast"] == 4 * CLI_FRAMES,
          f"{name}: {r['fast']} FAST launches for {CLI_FRAMES} frames")
    check(r["realign_calls"] == 2 and r["realign_launches"] == 2,
          f"{name}: {r['realign_launches']} pose launches in "
          f"{r['realign_calls']} realign calls")
    check(r["pose"] == r["realign_launches"] + r["verification_launches"],
          f"{name}: {r['pose']} pose launches outside realign and loop "
          "verification")
    for f in ("trajectory_frames_ba.tum", "trajectory_keyframes_ba.tum",
              "trajectory.ply", "trajectory.npz"):
        check(f in r["files"], f"{name}: the CLI wrote no {f}")


def cli_tum_phase(dev, lane, tmp: Path) -> dict:
    """The CLI over the lane on the card, gated on the JAX package's CPU
    runs of the same files (scripts/jax_cli_reference.py), then the CLI as
    a subprocess over its first 30 frames."""
    data = lane["root"]
    ini = TF.copy_config(tmp / "tum.ini")
    with KeepInputs(TR, "coarse_step", dev) as coarse, \
            KeepInputs(TR, "fine_step", dev) as fine, \
            KeepInputs(FD, "extract_orb", dev) as orb:
        r = cli_run(ini, data, tmp / "out", dev)
    r["kept"] = dict(coarse_step=coarse.kept(), fine_step=fine.kept(),
                     orb=orb.kept())
    J, O = JAX_CLI, JAX_CLI_OWN_ORB
    shown = {k: v for k, v in r.items()
             if k not in ("system", "realign_args", "kept")}
    phase("cli_tum", draw=draw_name(), frames=CLI_FRAMES, **shown,
          memory=memory(), jax_cpu=J,
          jax_cpu_own_orb=O, ate_ratio=r["ate_m"] / J["ate_m"],
          ate_ratio_own_orb=r["ate_m"] / O["ate_m"])
    for ref, name in ((J, "the JAX run"), (O, "the JAX run, own ORB")):
        check(abs(r["tracked"] - ref["tracked"]) <= 0.01 * ref["tracked"],
              f"CLI lane tracked {r['tracked']}, {name} {ref['tracked']}")
        check(abs(r["points"] - ref["points"]) <= 0.15 * ref["points"],
              f"CLI lane {r['points']} points, {name} {ref['points']}")
    check(abs(r["keyframes"] - J["keyframes"]) <= 0.1 * J["keyframes"],
          f"CLI lane {r['keyframes']} keyframes, the JAX run "
          f"{J['keyframes']}")
    check(abs(r["ate_m"] - J["ate_m"]) <= 0.25 * J["ate_m"],
          f"CLI lane ATE {r['ate_m']} m, the JAX run {J['ate_m']} m")
    check(abs(r["keyframes"] - O["keyframes"]) <= 1,
          f"CLI lane {r['keyframes']} keyframes, the JAX run with its own "
          f"ORB {O['keyframes']}")
    check(r["ate_m"] <= 2.0 * O["ate_m"],
          f"CLI lane ATE {r['ate_m']} m, the JAX run with its own ORB "
          f"{O['ate_m']} m")
    check_cli_counts("cli_tum", r)
    check_one_replay_per_call(r["graphs"], dict(coarse_step=coarse.calls,
                                                fine_step=fine.calls))
    out = tmp / "out_subprocess"
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "snakeslam_tpu_torch", str(ini), "--dataset",
         str(data), "--maxFrames", "30", "--outDir", str(out)],
        capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    seconds = time.perf_counter() - t0
    check(p.returncode == 0, f"python -m snakeslam_tpu_torch exited "
          f"{p.returncode}: {p.stderr[-2000:]}")
    files = sorted(x.name for x in out.iterdir())
    line = next((x for x in p.stdout.splitlines()
                 if x.startswith("tracked")), "")
    phase("cli_tum_subprocess", frames=30, seconds=seconds, files=files,
          line=line)
    check("trajectory_frames_ba.tum" in files and "trajectory.ply" in files,
          "the CLI subprocess wrote no trajectory or snapshot")
    check(line.startswith("tracked 30 frames"), f"subprocess: {line!r}")
    return r


def start_cli_cpu(lane, tmp: Path):
    """The port's CLI over the whole lane on the CPU (``--device cpu``), a
    process of its own that runs beside the card's phases on four CPU
    threads.  Returns (process, output directory, log path)."""
    ini = TF.copy_config(tmp / "tum_cpu.ini")
    out, log = tmp / "out_cpu", tmp / "cli_cpu.log"
    env = dict(os.environ, OMP_NUM_THREADS="4", MKL_NUM_THREADS="4")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "snakeslam_tpu_torch", str(ini),
             "--dataset", str(lane["root"]), "--outDir", str(out),
             "--device", "cpu"], stdout=fh, stderr=subprocess.STDOUT,
            cwd=Path(__file__).resolve().parent, env=env)
    return proc, out, log


def cli_cpu_gpu_phase(dev, lane, tmp: Path, sync: dict, cpu_run) -> None:
    """The CLI lane on the CPU against the card: three frames' ORB features
    bit for bit, then the CPU run (``start_cli_cpu``) against the card's
    sync run: the same counts, the same keyframes, every keyframe and
    frame centre within CLI_CPU_ATOL."""
    s = sync["system"].s
    det = {str(d): FeatureDetector(s, device=d) for d in ("cpu", dev)}
    for i, gray in lane["grays"].items():
        fc, fg = (det[d].detect(gray, i, 0.0) for d in ("cpu", str(dev)))
        for f in ("uv", "octave", "angle", "descriptors"):
            check(np.array_equal(getattr(fc, f), getattr(fg, f)),
                  f"CLI lane frame {i}: ORB {f} differ between CPU and card")
    proc, out, log = cpu_run
    t0 = time.perf_counter()
    rc = proc.wait(timeout=1200)
    waited = time.perf_counter() - t0
    text = log.read_text()
    check(rc == 0, f"the CLI on the CPU exited {rc}: {text[-2000:]}")
    m = re.search(r"tracked (\d+) frames", text)
    k = re.search(r"keyframes: (\d+)\s+points: (\d+)", text)
    cpu = dict(tracked=int(m.group(1)), keyframes=int(k.group(1)),
               points=int(k.group(2)))
    card = {c: sync[c] for c in cpu}
    diff = {}
    for name in ("keyframes", "frames"):
        tc, pc, _ = read_tum(out / f"trajectory_{name}_ba.tum")
        tg, pg, _ = read_tum(tmp / "out" / f"trajectory_{name}_ba.tum")
        check(np.array_equal(tc, tg),
              f"CLI lane: the CPU and the card keep other {name}")
        diff[name] = float(np.linalg.norm(pc - pg, axis=1).max())
    ate, _ = TF.ate_against_groundtruth(out / "trajectory_frames_ba.tum",
                                        lane["root"] / "groundtruth.txt")
    phase("cli_cpu_vs_gpu", draw=draw_name(), frames=CLI_FRAMES,
          orb_frames=sorted(
              lane["grays"]), cpu=cpu, gpu=card, max_centre_diff_m=diff,
          ate_m_cpu=ate, ate_m_gpu=sync["ate_m"], waited_s=waited)
    check(cpu == card, f"CLI lane on the CPU {cpu}, on the card {card}")
    for name, d in diff.items():
        check(d <= CLI_CPU_ATOL, f"CLI lane {name} centres differ by {d} m "
              "between the CPU and the card")


def fast_cli_phase(dev, lane, settings) -> None:
    """The FAST kernel on the CLI lane's own inputs: the four pyramid
    levels of one of its frames (B = 1), as ``FeatureDetector.detect``
    hands them over, against the plain version, exact."""
    levels = []
    # eagerly: a replay of ORB's graph makes no Python call of the wrapper
    with graphs.disabled(), Probe(OK, "fast_score_batch",
                                  after=lambda a, k: levels.append((a, k))):
        FeatureDetector(settings, device=dev).detect(
            lane["grays"][CLI_FRAMES // 2], 0, 0.0)
    check(len(levels) == settings.fd_levels,
          f"one CLI frame made {len(levels)} FAST calls")
    for lvl, (a, k) in enumerate(levels):
        imgs, th = a[0], a[1]
        sc, co = OK.fast_score_batch(*a, **k)
        sr, cr = OK.fast_score_batch_reference(*a, **k)
        torch.cuda.synchronize()
        check(torch.equal(co, cr), f"FAST corners differ (CLI level {lvl})")
        check(torch.equal(sc, sr), f"FAST scores differ (CLI level {lvl})")
        check(int(co.sum()) > 0, f"FAST found no corner (CLI level {lvl})")
        b_ms, b_by, pass_share = fast_bound(imgs, th)
        phase("fast_cli", level=lvl, shape=list(imgs.shape), th=th,
              corners=int(co.sum()), max_abs_err=(sc - sr).abs().max().item(),
              device_us=graph_us(lambda: OK.fast_score_batch(*a, **k), k=20),
              bound_us=b_ms * 1e3, bound_by=b_by,
              compass_pass_share=pass_share)


def cli_tum_async_phase(dev, lane, tmp: Path, sync: dict) -> None:
    """The same lane with async_mode and async_lba: the front-end on a
    producer thread, the local BA and the back-end queues on workers."""
    ini = TF.copy_config(tmp / "tum_async.ini", async_mode="true",
                   async_lba="true")
    main = threading.get_ident()
    # the entries held here, so that no new entry takes a dropped one's id
    lba_before = LBA.solve_window.entries()
    orb_before = ORB.extract_orb.entries()
    r = cli_run(ini, lane["root"], tmp / "out_async", dev)
    # the local BA captured on the worker while the main thread replayed
    # the tracking steps; ORB captured and replayed on the producer thread
    before = {id(e) for e in lba_before + orb_before}
    worker = [e for e in LBA.solve_window.entries()
              if id(e) not in before and e.thread != main]
    producer = [e for e in ORB.extract_orb.entries()
                if id(e) not in before and e.thread != main]
    shown = {k: v for k, v in r.items()
             if k not in ("system", "realign_args")}
    phase("cli_tum_async", draw=draw_name(), frames=CLI_FRAMES, **shown,
          lba_graphs_captured_on_workers=len(worker),
          lba_replays_on_workers=sum(e.replays for e in worker),
          orb_graphs_captured_on_producer=len(producer),
          orb_replays_on_producer=sum(e.replays for e in producer),
          memory=memory(),
          sync_wall_s=sync["wall_s"], sync_ate_m=sync["ate_m"])
    check(len(worker) >= 1 and r["graphs"]["lba_solve"]["captures"] >= 1,
          f"no local-BA graph captured on a worker thread: {r['graphs']}")
    check(len(producer) == 1
          and producer[0].replays == CLI_FRAMES - 1,
          f"ORB on the producer thread: {len(producer)} graphs, "
          f"{[e.replays for e in producer]} replays for {CLI_FRAMES} frames")
    check(all(r["graphs"].get(p, {}).get("replays", 0) > 0
              for p in ("coarse_step", "fine_step")),
          f"the tracking steps did not replay in the async run: "
          f"{r['graphs']}")
    check(r["system"].s.async_mode and r["system"]._async_lba is not None,
          "the async INI did not turn async mode on")
    check(r["tracked"] >= 0.99 * sync["tracked"],
          f"async lane tracked {r['tracked']}, sync {sync['tracked']}")
    check(r["ate_m"] <= 2.0 * sync["ate_m"],
          f"async lane ATE {r['ate_m']} m, sync {sync['ate_m']} m")
    check(r["lba_runs"] >= 1, "the async local BA never ran")
    check_cli_counts("cli_tum_async", r)


def depth_filter_phase(dev, lane, sync: dict) -> None:
    """The RGB-D depth filter at 640x480 on the lane's depth frames, card
    against CPU, then Input with the filter on over the whole sequence
    (features with depth per frame beside the unfiltered CLI run's)."""
    proc = {d: DepthProcessor(TF.FR1["fx"], TF.FR1_BF, device=d)
            for d in ("cpu", dev)}
    max_rel = 0.0
    for depth in lane["depths"][:DEPTH_FILTER_FRAMES]:
        c = proc["cpu"].process(depth)
        g = proc[dev].process(depth)
        check(np.array_equal(g > 0, c > 0),
              "depth filter: the card keeps other pixels than the CPU")
        keep = c > 0
        max_rel = max(max_rel, float((np.abs(g - c)[keep]
                                      / c[keep]).max()))
    check(max_rel <= DEPTH_RTOL, f"depth filter: card and CPU {max_rel} "
          "apart (relative)")
    t = torch.as_tensor(lane["depths"][0], dtype=torch.float32)
    tg = t.to(dev)
    ms = dict(card=_wall_ms(lambda: process_depth(tg, TF.FR1_BF), True, 20),
              cpu=_wall_ms(lambda: process_depth(t, TF.FR1_BF), False, 5))
    kept = float((proc["cpu"].process(lane["depths"][0]) > 0).mean())
    s = Settings.from_ini(TF.copy_config(Path(lane["root"]).parent
                                   / "depth_filter.ini"))
    s.set_default_parameters_for_dataset()
    s.depth_filter_enable = True
    inp = Input(s, dataset=TumRgbdDataset(lane["root"]), device=dev)
    check(inp.depth_processor is not None,
          "Input did not build the depth filter")
    t0 = time.perf_counter()
    counts = [int((f.depth > 0).sum()) for f in inp]
    filtered = dict(mean=float(np.mean(counts)), min=int(np.min(counts)),
                    seconds=time.perf_counter() - t0)
    phase("depth_filter", frames=DEPTH_FILTER_FRAMES, shape=[480, 640],
          gauss_radius=2, kept_share=kept, max_rel_diff=max_rel,
          ms_per_frame=ms, features_with_depth=dict(
              filter_on=filtered, filter_off=sync["features_with_depth"]))
    check(len(counts) == CLI_FRAMES and filtered["min"] >= 150,
          "the filtered lane keeps fewer than 150 features with depth")


def tsdf_phase(dev, lane) -> None:
    """TSDF fusion of the lane's first frames at V = 128 and 256 on the
    card and the CPU."""
    depths = [torch.as_tensor(d, dtype=torch.float32)
              for d in lane["depths"][:TSDF_FRAMES]]
    poses = [torch.as_tensor(T) for _, T in lane["traj"][:TSDF_FRAMES]]
    cam = (TF.FR1["fx"], TF.FR1["fy"], TF.FR1["cx"], TF.FR1["cy"])
    for V in (128, 256):
        vols, ms = {}, {}
        for d, sync in (("cpu", False), (dev, True)):
            vol = TSDF.create_volume(V, extent=6.0, origin=(-3.0, -3.0, -3.0),
                                     device=d)
            ds = [x.to(d) for x in depths]
            times = []
            for depth, T in zip(ds, poses):
                t0 = time.perf_counter()
                vol = TSDF.integrate(vol, depth, T, *cam, TSDF_TRUNC)
                if sync:
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            vols[str(d)] = vol
            ms["card" if sync else "cpu"] = statistics.median(times[1:])
        c, g = vols["cpu"], vols[str(dev)]
        diff = float((g.tsdf.cpu() - c.tsdf).abs().max())
        weights_equal = bool(torch.equal(g.weight.cpu(), c.weight))
        pc = TSDF.extract_surface_points(c)
        pg = TSDF.extract_surface_points(g)
        phase("tsdf", V=V, frames=TSDF_FRAMES, trunc_m=TSDF_TRUNC,
              ms_per_integration=ms, max_abs_diff=diff,
              weights_equal=weights_equal, surface_points=[len(pc), len(pg)],
              observed_share=float((c.weight > 0).float().mean()))
        check(diff <= TSDF_ATOL, f"TSDF V={V}: card and CPU {diff} apart")
        check(weights_equal, f"TSDF V={V}: weights differ")
        check(len(pc) == len(pg) and len(pc) > 1000,
              f"TSDF V={V}: {len(pg)} surface points on the card, "
              f"{len(pc)} on the CPU")


def checkpoint_phase(tmp: Path, system) -> None:
    """save_map of the CLI lane's map, load_map, every field compared."""
    smap = system.map
    path = tmp / "map.npz"
    t0 = time.perf_counter()
    save_map(smap, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_map(path)
    load_s = time.perf_counter() - t0
    fields = SER._KF_FIELDS + SER._PT_FIELDS
    for f in fields:
        a, b = getattr(smap, f), getattr(back, f)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"checkpoint: field {f} differs after load")
    check((back._next_kf, back._next_pt, back.state, back._free_kfs,
           back._free_pts) == (smap._next_kf, smap._next_pt, smap.state,
                               smap._free_kfs, smap._free_pts),
          "checkpoint: allocation state differs after load")
    phase("checkpoint", fields=len(fields), keyframes=back.n_keyframes,
          points=back.n_points, bytes=path.stat().st_size, save_s=save_s,
          load_s=load_s)


def cli_phases(dev) -> dict:
    """The CLI lane's phases; returns the sync run's launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lane = tum_render_phase(tmp / "tum")
        cpu_run = start_cli_cpu(lane, tmp)
        try:
            sync = cli_tum_phase(dev, lane, tmp)
            fast_cli_phase(dev, lane, sync["system"].s)
            pose_cases_phase("pose_cli",
                             (("realign", sync["realign_args"]),))
            cli_tum_async_phase(dev, lane, tmp, sync)
            checkpoint_phase(tmp, sync["system"])
            depth_filter_phase(dev, lane, sync)
            tsdf_phase(dev, lane)
            cli_cpu_gpu_phase(dev, lane, tmp, sync, cpu_run)
        finally:
            if cpu_run[0].poll() is None:
                cpu_run[0].kill()
                cpu_run[0].wait()
    return dict(fast=sync["fast"], pose=sync["pose"], kept=sync["kept"])


def _host_leaves(tree) -> list:
    """The tensors of an output tree as host arrays, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree.cpu().numpy()]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [a for v in tree for a in _host_leaves(v)]


def _same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(a, b))


def replay_us(graph, reps: int = 20) -> float:
    """Device time of one replay of ``graph`` in microseconds: the median
    CUDA-event interval around a replay, replays back to back."""
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return statistics.median(times)


def graphs_phase(kept: dict) -> dict:
    """Each compiled program on the inputs a lane gave it (``kept``: name
    -> (program, (args, kwargs))): a replay against the eager run inside
    ``graphs.disabled()``, bit for bit, and against a rerun; the device
    time of a replay (CUDA events around it) beside the wall time of an
    eager call and of a compiled call (its input copies and the replay);
    then captures, replays, cache entries and pool MiB of every program."""
    rows = {}
    for name, (prog, (a, k)) in kept.items():
        prog(*a, **k)             # this thread's graph of the key
        torch.cuda.synchronize()
        replay = _host_leaves(prog(*a, **k))
        rerun = _host_leaves(prog(*a, **k))
        eager_ms, call_ms = [], []
        with graphs.disabled():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = prog(*a, **k)
                torch.cuda.synchronize()
                eager_ms.append((time.perf_counter() - t0) * 1e3)
            eager = _host_leaves(out)
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog(*a, **k)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t0) * 1e3)
        rows[name] = dict(
            bit_identical=_same_bits(replay, eager),
            rerun_bit_identical=_same_bits(replay, rerun),
            device_us_per_replay=replay_us(prog.graph(*a, **k)),
            eager_wall_ms=statistics.median(eager_ms),
            call_wall_ms=statistics.median(call_ms))
        if not rows[name]["bit_identical"]:
            rows[name]["max_abs_diff"] = [
                float(np.max(np.abs(x.astype(np.float64)
                                    - y.astype(np.float64))))
                if x.size else 0.0 for x, y in zip(replay, eager)]
    st = graphs.stats()
    mem = memory()
    phase("graphs", programs=rows, stats=st, memory=mem, card=card_line())
    for name, r in rows.items():
        check(r["bit_identical"], f"{name}: the graph's replay differs "
              f"from the eager run: {r.get('max_abs_diff')}")
        check(r["rerun_bit_identical"], f"{name}: a rerun differs")
    # every lane's systems are still alive here, with their graphs
    check(mem["reserved_gib"] <= RESERVED_GIB_MAX
          and mem["graph_pool_gib"] <= GRAPH_POOL_GIB_MAX,
          f"memory after the lanes: {mem}, limits {RESERVED_GIB_MAX} GiB "
          f"reserved, {GRAPH_POOL_GIB_MAX} GiB in graph pools")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    only = None
    if len(sys.argv) > 1:
        check(len(sys.argv) == 3 and sys.argv[1] == "--only",
              "usage: chip_smoke.py [--only phase,phase]")
        only = set(sys.argv[2].split(","))
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())
    phase("build", seconds=cuda_build.build(
        PF.SOURCE, OK.FAST_SOURCE, OK.PATCH_SOURCE, force=True))
    if only is not None:
        if "prng" in only:
            prng_phase(dev)
        if "loop" in only or "multichip" in only:
            loop = loop_lane_phase(dev)
        if "loop" in only:
            pose_batched_phase(dev, loop)
            loop_cpu_gpu_phase(dev)
        if "multichip" in only:
            multichip_phases(dev, loop)
        if "mono_vi" in only:
            pose_mono_phase(dev, mono_vi_lane_phase(dev))
        if "vi_solvers" in only:
            vi_solvers_phase(dev)
        if "mono_vi_cpu_gpu" in only:
            mono_vi_cpu_gpu_phase(dev)
        if "cli" in only:
            cli_phases(dev)
        if "graphs" in only:
            _, _, kept = slice_phase(dev)
            pix = pixels_phase(dev, render_pixels_lane())
            loop = loop_lane_phase(dev)
            mono_vi = mono_vi_lane_phase(dev)
            with tempfile.TemporaryDirectory() as tmp:
                tmp = Path(tmp)
                sync = cli_tum_phase(dev, tum_render_phase(tmp / "tum"), tmp)
            graphs_phase({**kept, **pix["kept"], **loop["kept"],
                          **mono_vi["kept"], **sync["kept"]})
        print(card_line(), flush=True)
        return 0
    kern = kernel_phase(dev)
    lane = render_pixels_lane()
    fast = fast_phase(dev, lane)
    patch = patch_phase(dev)
    prng_phase(dev)
    smooth_launches, smooth, kept = slice_phase(dev)
    kf_cycle_phase(smooth)
    pix = pixels_phase(dev, lane)
    cpu_gpu_phase(dev)
    pixels_cpu_gpu_phase(dev, lane)
    ba_phase(dev)
    triangulation_phase(dev)
    loop = loop_lane_phase(dev)
    pose_batched_phase(dev, loop)
    loop_cpu_gpu_phase(dev)
    sharded = multichip_phases(dev, loop)
    mono_vi = mono_vi_lane_phase(dev)
    mono_fine = pose_mono_phase(dev, mono_vi)
    vi_solvers_phase(dev)
    mono_vi_cpu_gpu_phase(dev)
    cli = cli_phases(dev)
    programs = graphs_phase({**kept, **pix["kept"], **loop["kept"],
                             **mono_vi["kept"], **cli["kept"]})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "pose_refine_fused",
        "route": "cuda",
        "source": "snakeslam_tpu_torch/csrc/pose_refine.cu",
        "replaces": "snakeslam_tpu/ops/pose_pallas.py:258",
        # the smooth, pixels, loop, sharded loop, mono-VI and CLI lanes'
        # runs, each counted alone (the loop lanes': tracking, loop
        # verification and the realign; the mono-VI lane's: tracking and
        # the realign; the CLI lane's: the realign)
        "launches": (smooth_launches + pix["pose"] + loop["launches"]
                     + sharded["launches"] + mono_vi["launches"]
                     + cli["pose"]),
        **kern,
        # the mono-VI lane's own fine (2 x 2) problem, every row mono
        "mono_device_ms": mono_fine["device_us"] / 1e3,
        "mono_bound_ms": mono_fine["bound_us"] / 1e3,
        # one replay of the smooth lane's window graph (W = 128): the
        # kernel launched twice a frame inside it
        "window_replay_device_ms":
            programs["window_track"]["device_us_per_replay"] / 1e3,
    }, {
        "name": "fast_score_batch",
        "route": "cuda",
        "source": "snakeslam_tpu_torch/csrc/fast_score.cu",
        "replaces": "snakeslam_tpu/ops/orb_pallas.py:96",
        # the pixels lane's and the CLI lane's (one a level a frame)
        "launches": pix["fast"] + cli["fast"],
        **fast,
    }, {
        "name": "patch_gather",
        "route": "cuda",
        "source": "snakeslam_tpu_torch/csrc/patch_gather.cu",
        "replaces": "snakeslam_tpu/ops/orb_pallas.py:176",
        # no path of either package calls it (only tests): held in its
        # kernel phase alone
        "launches": 0,
        **patch,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
