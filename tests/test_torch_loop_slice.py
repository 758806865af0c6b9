"""Loop closing with its global-BA polish, in both packages on the same
input.

The map is the ring of ``snakeslam_tpu_torch/utils/loop_problems.py`` (20
keyframes); as tests/test_loop_reloc.py's step-drift test does, the map
points shared between the newest three keyframes and the rest are split
(the new side gets clones), and the new side with the points only it
observes moves by the Sim3 exp(0.25, -0.1, 0.15, 0, 0.03, 0.01, 0)
(``drift_newest``).  The same map then goes
into both packages, every keyframe into the BoW database, and
``LoopClosing.process`` runs on the new side in order with the global BA
on.  Tolerances: the same number of loops closed (>= 1), every keyframe
centre within 5 mm between the packages, the drifted keyframes pulled
back to within 5 cm of the truth.
"""

import numpy as np
import pytest

from test_torch_fusion import _copy_map
from test_torch_loop import REPO, _jax_settings

from snakeslam_tpu.map.slam_map import SlamMap as JMap
from snakeslam_tpu_torch.map.slam_map import SlamMap as TMap
from snakeslam_tpu_torch.utils import loop_problems as LP

N_NEW = 3


def _drifted_ring():
    """The ring with its newest keyframes split off and drifted; returns
    (port map, port settings, new-side keyframes, their true poses)."""
    smap, s, _, _ = LP.build_ring()
    new_side, truth = LP.drift_newest(smap, N_NEW)
    return smap, s, new_side, truth


def _close(pkg, smap, s):
    if pkg == "jax":
        from snakeslam_tpu.loop.keyframe_database import KeyframeDatabase
        from snakeslam_tpu.loop.loop_closing import LoopClosing
        from snakeslam_tpu.ops import bow as BOW
        from snakeslam_tpu.optim.gba import GlobalBA

        voc = BOW.load_vocabulary_cached(
            REPO / "snakeslam_tpu" / "data" / "orbvoc_synth.npz")
        lc = LoopClosing(s, smap, KeyframeDatabase(voc, smap),
                         gba=GlobalBA(s, smap))
    else:
        from snakeslam_tpu_torch.loop.keyframe_database import \
            KeyframeDatabase
        from snakeslam_tpu_torch.loop.loop_closing import LoopClosing
        from snakeslam_tpu_torch.ops import bow as BOW
        from snakeslam_tpu_torch.optim.gba import GlobalBA

        voc = BOW.load_vocabulary_cached(
            REPO / "snakeslam_tpu_torch" / "data" / "orbvoc_synth.npz")
        lc = LoopClosing(s, smap, KeyframeDatabase(voc, smap), "cpu",
                         gba=GlobalBA(s, smap, "cpu"))
    return lc


@pytest.fixture(scope="module")
def ring_closed():
    smap, s, new_side, truth = _drifted_ring()
    out = {}
    for pkg, m, st in (("jax", _copy_map(smap, JMap), _jax_settings(s)),
                       ("port", _copy_map(smap, TMap), s)):
        lc = _close(pkg, m, st)
        for k in m.valid_keyframes():
            lc.db.add(int(k))
        for k in new_side:
            lc.process(k)
        out[pkg] = (lc, m)
    return out, new_side, truth


def test_loop_closes_in_both(ring_closed):
    out, _, _ = ring_closed
    nj = out["jax"][0].n_loops_closed
    nt = out["port"][0].n_loops_closed
    assert nt == nj >= 1


def test_corrected_centres_match(ring_closed):
    out, new_side, truth = ring_closed
    jm, tm = out["jax"][1], out["port"][1]
    kfs = jm.valid_keyframes()
    np.testing.assert_array_equal(tm.valid_keyframes(), kfs)
    cj = np.linalg.inv(jm.kf_pose[kfs])[:, :3, 3]
    ct = np.linalg.inv(tm.kf_pose[kfs])[:, :3, 3]
    diff = np.linalg.norm(ct - cj, axis=1).max()
    assert diff < 5e-3, f"keyframe centres differ by {diff} m"
    for k in new_side:
        err = np.linalg.norm(np.linalg.inv(tm.kf_pose[k])[:3, 3]
                             - np.linalg.inv(truth[k])[:3, 3])
        assert err < 0.05, f"keyframe {k} left {err} m from the truth"
