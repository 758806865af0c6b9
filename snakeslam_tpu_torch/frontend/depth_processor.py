"""Depth-map preprocessing: hysteresis outlier rejection + edge-aware blur.

Counterpart of ``snakeslam_tpu/frontend/depth_processor.py``, parity with
the reference's ``DepthProcessor2`` (saiga DepthmapPreprocessor), run over
every RGB-D depth image (reference: Snake/System/System.cpp:226-241):

1. **Noise model** — one disparity step at depth ``z`` spans
   ``dz = z^2 / bf``; every threshold is a multiple of that local step.
2. **Hysteresis edge rejection** — a pixel whose least depth difference to
   any 8-neighbour, in units of the pair's step, exceeds ``hyst_max`` is a
   flying pixel and is cleared; one in the weak band ``(hyst_min,
   hyst_max]`` survives only when 4-connected to a strong pixel, grown for
   ``hyst_iters`` rounds.
3. **Edge-aware Gaussian** — ``(2r+1)^2`` taps masked to neighbours within
   ``hyst_min`` steps of the centre depth, renormalised.

Invalid input (``<= dont_care``) stays invalid (0).  Plain torch ops on the
depth image's device: each neighbourhood is one stack of shifted views of
a padded image, so the whole filter is a few dozen launches per frame.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BIG = 1e9


def _shifts(img: torch.Tensor, offsets, fill: float) -> torch.Tensor:
    """(len(offsets), H, W): ``out[k, y, x] = img[y - dy, x - dx]`` for
    ``offsets[k] = (dy, dx)``, ``fill`` where that falls outside the image
    (``jnp.roll`` plus fill of the vacated rows and columns)."""
    r = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    H, W = img.shape
    pad = F.pad(img[None, None], (r, r, r, r), value=fill)[0, 0]
    return torch.stack([pad[r - dy:r - dy + H, r - dx:r - dx + W]
                        for dy, dx in offsets])


_RING = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
         if (dy, dx) != (0, 0)]
_CROSS = [(1, 0), (-1, 0), (0, 1), (0, -1)]


def gauss_taps(radius: int) -> tuple[list, np.ndarray]:
    """The ``(2r+1)^2`` offsets and their float32 Gaussian weights
    (sigma = r / 2)."""
    sigma = max(radius / 2.0, 1e-3)
    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    w = np.array([np.exp(-(dy * dy + dx * dx) / (2 * sigma * sigma))
                  for dy, dx in offs], dtype=np.float32)
    return offs, w


def process_depth(depth: torch.Tensor, bf: float, dont_care: float = 0.0,
                  gauss_radius: int = 2, hyst_min: float = 7.0,
                  hyst_max: float = 9.0,
                  hyst_iters: int = 4) -> torch.Tensor:
    """Filter one (H, W) depth image on its device; returns float32 depth
    of the same shape with outliers = 0.  ``bf`` is fx * baseline of the
    (virtual) stereo depth camera."""
    z = depth.to(torch.float32)
    valid = z > dont_care
    z = torch.where(valid, z, 0.0)
    bf_t = torch.tensor(bf, dtype=torch.float32, device=z.device)
    bf_c = torch.clamp(bf_t, min=1e-6)

    # hysteresis support: min |z - z_nb| over the 8-ring in units of the
    # pairwise step min(z, z_nb)^2 / bf
    nb = _shifts(torch.where(valid, z, _BIG), _RING, _BIG)
    zmin = torch.minimum(nb.abs(), z)
    dz_pair = zmin * zmin / bf_c
    ratio = (nb - z).abs() / torch.clamp(dz_pair, min=1e-9)
    min_ratio = torch.clamp(ratio.amin(0), max=_BIG)

    strong = valid & (min_ratio <= hyst_min)
    weak = valid & (min_ratio <= hyst_max) & ~strong
    keep = strong
    for _ in range(hyst_iters):
        n = _shifts(keep.to(torch.float32), _CROSS, 0.0).sum(0)
        keep = keep | (weak & (n > 0))
    z = torch.where(keep, z, 0.0)

    r = int(gauss_radius)
    if r > 0:
        offs, w_np = gauss_taps(r)
        w = torch.from_numpy(w_np).to(z.device)[:, None, None]
        nb = _shifts(z, offs, 0.0)
        zmin = torch.minimum(torch.where(nb > 0, nb, _BIG), z)
        thr = hyst_min * zmin * zmin / bf_c
        ok = (nb > 0) & ((nb - z).abs() <= thr)
        wi = torch.where(ok, w, 0.0)
        acc = (wi * nb).sum(0)
        wacc = wi.sum(0)
        z = torch.where(keep & (wacc > 0),
                        acc / torch.clamp(wacc, min=1e-9), z)
    return torch.where(keep, z, 0.0)


class DepthProcessor:
    """Host-side wrapper with the reference's Settings shape (dont_care,
    gauss_radius, hyst_min, hyst_max, camera), filtering on ``device``."""

    def __init__(self, fx: float, bf: float, dont_care: float = 0.0,
                 gauss_radius: int = 2, hyst_min: float = 7.0,
                 hyst_max: float = 9.0, *, device):
        self.fx = float(fx)
        self.bf = float(bf)
        self.dont_care = float(dont_care)
        self.gauss_radius = int(gauss_radius)
        self.hyst_min = float(hyst_min)
        self.hyst_max = float(hyst_max)
        self.device = torch.device(device)

    def process(self, depth: np.ndarray) -> np.ndarray:
        out = process_depth(
            torch.as_tensor(np.asarray(depth, dtype=np.float32),
                            device=self.device),
            self.bf, dont_care=self.dont_care,
            gauss_radius=self.gauss_radius, hyst_min=self.hyst_min,
            hyst_max=self.hyst_max)
        return out.cpu().numpy()
