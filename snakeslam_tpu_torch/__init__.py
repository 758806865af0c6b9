"""snakeslam_tpu_torch — the SLAM framework in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``snakeslam_tpu`` that keeps its sub-package
layout and module names, so each module's counterpart is found under the
same path:

  core/      SE3 Lie algebra, camera model, scale pyramid, trajectory eval
  ops/       tensor ops: linear algebra, descriptors, matching, pose GN,
             and the hand-written CUDA pose kernel (ops/pose_fused.py,
             csrc/pose_refine.cu)
  models/    per-frame and windowed tracking steps
  map/       host map (numpy pools) and its device point table
  tracking/  tracker state machine, staging, windowed runner
  mapping/   keyframe insertion (synchronous half)
  system/    settings, stats, SlamSystem
  utils/     synthetic worlds, conversion of JAX-package state
  frontend/  synthetic feature source

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
