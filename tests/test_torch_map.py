"""The port's map: its device mirror stays fresh across ``SlamMap.clear()``.

An early tracking loss clears the map and the next frame re-initializes it.
The generation counter must not restart, or the device mirror (keyed on it)
serves the old map's rows to the new map's snapshots.  The JAX package
restarts the counter; the port deliberately does not.
"""

import numpy as np
import torch

from snakeslam_tpu_torch.map.slam_map import FrameData, SlamMap


def _frame(frame_id, n=4):
    rng = np.random.default_rng(frame_id)
    return FrameData(
        frame_id=frame_id, timestamp=0.1 * frame_id,
        uv=rng.uniform(0, 100, (n, 2)), octave=np.zeros(n, dtype=np.int32),
        angle=np.zeros(n, dtype=np.float32),
        descriptors=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        right=np.full(n, -1.0), depth=np.full(n, -1.0), pose_cw=np.eye(4))


def _populate(smap, frame_id, offset):
    kf = smap.allocate_keyframe(_frame(frame_id))
    ids = [smap.allocate_point(np.array([offset + i, 0.0, 5.0]),
                               np.full(32, i, dtype=np.uint8), kf, 5.0, 0,
                               np.array([0.0, 0.0, 1.0]))
           for i in range(3)]
    return np.asarray(ids)


def test_device_mirror_refreshes_after_clear():
    smap = SlamMap(max_keyframes=8, max_points=4096, max_features=16)
    mirror = smap.device_mirror("cpu")
    ids = _populate(smap, 0, offset=10.0)
    lm, _ = mirror.gather(ids, n_slots=4)
    assert torch.equal(lm.position[:3, 0], torch.tensor([10.0, 11.0, 12.0]))

    state_before = smap.state
    smap.clear()
    assert smap.device_mirror("cpu") is mirror
    ids = _populate(smap, 1, offset=-20.0)
    lm, _ = mirror.gather(ids, n_slots=4)
    np.testing.assert_array_equal(lm.position[:3, 0].numpy(),
                                  [-20.0, -19.0, -18.0])
    assert smap.state > state_before + 1, "clear() must not restart the counter"
    assert smap.n_keyframes == 1 and smap.n_points == 3


def test_kf_feature_pool_and_cache_do_not_outlive_clear():
    """The keyframe feature pool and the staged keyframe features are keyed
    on keyframe ids, which restart at 0 after clear(): the new map's
    keyframe 0 must get its own features, and erasing it must still free
    its pool row (the JAX package keeps the old map's row and loses the
    erase hook)."""
    from snakeslam_tpu_torch.map.kf_pool import pool_features
    from snakeslam_tpu_torch.tracking.staging import kf_features_cached

    smap = SlamMap(max_keyframes=8, max_points=64, max_features=16)
    assert smap.allocate_keyframe(_frame(0)) == 0
    pool = smap.kf_feature_pool(16, "cpu")
    pool.slots_for([0])
    kf_features_cached(smap, 0, 16, "cpu")

    smap.clear()
    new = _frame(7)
    assert smap.allocate_keyframe(new) == 0
    pool = smap.kf_feature_pool(16, "cpu")
    feats = pool_features(pool.arrays, int(pool.slots_for([0])[0]))
    cached = kf_features_cached(smap, 0, 16, "cpu")
    for f in (feats, cached):
        np.testing.assert_array_equal(f.uv[:4].numpy(),
                                      new.uv.astype(np.float32))
        np.testing.assert_array_equal(
            np.packbits(f.desc_bits[:4].numpy().astype(np.uint8), axis=-1,
                        bitorder="little"), new.descriptors)
    smap.erase_keyframe(0)
    assert 0 not in pool._slot_of
