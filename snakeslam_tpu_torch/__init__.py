"""snakeslam_tpu_torch — the SLAM framework in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``snakeslam_tpu`` that keeps its sub-package
layout and module names, so each module's counterpart is found under the
same path:

  core/      SE3 / Sim3 Lie algebra, camera model and distortion, scale
             pyramid, trajectory eval
  ops/       tensor ops: linear algebra, descriptors, matching, pose GN, ORB,
             triangulation, two-view geometry and its RANSACs, bundle
             adjustment, BoW, Sim3 solver, pose-graph optimization, IMU
             preintegration and the IMU solvers, TSDF fusion, and the
             hand-written CUDA
             kernels (ops/pose_fused.py, ops/orb_kernels.py; sources in
             csrc/)
  models/    per-frame and windowed tracking steps
  map/       host map (numpy pools), its device point table, the keyframe
             feature pool, checkpoints and the chaos hooks
  tracking/  tracker state machine, monocular two-frame initializer,
             staging, windowed runner
  mapping/   keyframe insertion and the keyframe cycle (triangulation,
             neighbour fusion, local BA dispatch and commit)
  optim/     local BA, global BA, observation packing, simplification, the
             deferred mapper
  loop/      keyframe database, Sim3 loop closing, relocalization
  imu/       the decoupled visual-inertial state solver (gyro bias, gravity
             and scale, staged refinement, the final alternation)
  system/    settings, the tracer (stats: spans and counters, off by
             default), delayed queues, the async pipeline, SlamSystem
  utils/     synthetic and rendered worlds, the rendered TUM-RGBD sequence,
             synthetic IMU, seeded problems
             (pose, back-end, BA, loop, visual-inertial), conversion of
             JAX-package state, the kernels' build helper, the native runtime
             library
  frontend/  synthetic feature source, dataset readers and Input, the
             pixels-in stereo front-end, feature detector and preprocessing,
             the RGB-D depth filter, stereo rectification
  viewer/    map / frame snapshot export and the offline map plot
  parallel/  a device mesh driven by one process, the sharded Hamming
             matcher and the sharded global-BA step (``n_devices > 1``)
  __main__   the dataset CLI: ``python -m snakeslam_tpu_torch <config.ini>
             --dataset <dir> [--device cpu]``
  entry      the fine-tracking step on seeded inputs and the
             multi-device dry run

State is created on an explicit ``device``; CPU tensors take each kernel's
plain PyTorch version, CUDA tensors launch the kernel.
"""

__version__ = "0.1.0"

import torch as _torch

# float32 policy: the pose GN normal equations and SE3 chains need true
# f32, as the JAX package forces with jax_default_matmul_precision="highest"
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
