"""The BAL cell: its generator at the published counts, its caller and
check at a size the CPU runs in seconds, the faults the check catches,
the control, and the TSQR's operation count."""
import numpy as np
import pytest
import torch

from qrbench import bal_scene, control, registry, run
from qrbench.roofline import tsqr

CELL = "bal-venice52-fit"


def small_cell():
    """(bench, config, mix) of the BAL cell cut to 6 cameras, 300 points and
    1,200 observations: its widths (9 camera parameters) as the file says."""
    bench = registry.benchmark()
    _, config, mix = registry.cell(bench, CELL)
    return bench, {**config, "cameras": 6, "points": 300, "observations": 1200}, \
        {**mix, "catalog_calls": 2, "sample_calls": 2}


def run_small():
    bench, config, mix = small_cell()
    return run.run_cell(CELL, 2**33 + 5, 0.2, False, device="cpu", bench=bench, config=config,
                        mix=mix)


def test_the_pattern_at_the_published_counts():
    _, config, mix = registry.cell(registry.benchmark(), CELL)
    pat = bal_scene.pattern(config, mix["catalog_seed"])
    assert (config["cameras"], config["points"], config["observations"]) == (52, 64053, 347173)
    assert pat.obs_cam.size == pat.obs_pt.size == 347173 == int(pat.track.sum())
    assert pat.track.min() >= 2 and pat.track.max() <= 52
    assert np.array_equal(np.bincount(pat.obs_pt, minlength=64053), pat.track)
    pairs = pat.obs_pt * 52 + pat.obs_cam
    assert np.unique(pairs).size == pairs.size  # a point's cameras are distinct
    again = bal_scene.pattern(config, mix["catalog_seed"])
    assert np.array_equal(again.obs_cam, pat.obs_cam) and np.array_equal(again.obs_pt, pat.obs_pt)
    other = bal_scene.pattern(config, mix["catalog_seed"] + 1)
    assert not np.array_equal(other.obs_pt, pat.obs_pt)


def test_scenes_differ_in_values_only():
    _, config, mix = small_cell()
    pat, scenes = bal_scene.catalog(config, mix)
    assert len(scenes) == 2 and not np.array_equal(scenes[0].uv, scenes[1].uv)
    for s in scenes:
        cams = s.cams[pat.obs_cam]
        R = bal_scene._rotation(cams[:, :3])
        P = (R @ s.pts[pat.obs_pt][:, :, None])[:, :, 0] + cams[:, 3:6]
        assert (P[:, 2] < 0).all()  # every point in front of every camera that sees it
        assert s.uv.shape == (1200, 2) and s.cams0.shape == (6, 9) and s.pts0.shape == (300, 3)


def test_sound_program_is_correct():
    res, checks = run_small()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(checks) == {"cost_gap", "proj_gap"}


def test_a_dropped_bucket(monkeypatch):
    """The step leaves out its last bucket: those points never move."""
    from qrkit_tpu_torch import functional

    whole = functional._block_angular_lstsq_ragged

    def dropped(left, right, slots, b, dest, tail, tail_b, rows, marks):
        x1, x2 = whole(left[:-1], right[:-1], slots[:-1], b[:-1], dest[:-1], tail, tail_b, rows,
                       marks)
        return (*x1, left[-1].new_zeros(left[-1].shape[0], left[-1].shape[2])), x2

    monkeypatch.setattr(functional, "_block_angular_lstsq_ragged", dropped)
    res, checks = run_small()
    assert not res["correct"] and checks["cost_gap"][0] > checks["cost_gap"][1]


def test_a_bfloat16_step(monkeypatch):
    """The step's operands and its result rounded to bfloat16."""
    from qrkit_tpu_torch.examples import bal

    whole = bal._damped_step_aux
    bf = lambda t: t.to(torch.bfloat16).to(t.dtype)  # noqa: E731
    monkeypatch.setattr(bal, "_damped_step_aux",
                        lambda x, r, lam, aux: bf(whole(bf(x), bf(r), lam, aux)))
    res, checks = run_small()
    assert not res["correct"]


def test_control_fails():
    bench, config, mix = small_cell()
    got = control.readings(CELL, "control", 2**35 + 1, 2, "cpu", config, mix, bench)
    assert not got["within"]


def test_tsqr_count_by_hand():
    """Two shards of a 10 × 3 bottom: each shard's QR of 5 × 3 (2·5·9 − 18
    = 72), the second stage's of 6 × 3 (2·6·9 − 18 = 90), Qᵀ on the rhs 4·5·3
    a shard and 4·2·3·3; bytes: the bottom [10, 4], R [3, 3] and y [3]."""
    nbytes, flops = tsqr.cost(10, 3, 2)
    assert flops == 2 * 72 + 90 + 2 * 60 + 72
    assert nbytes == 4 * (40 + 9 + 3)
    # the padded shard: 11 rows over 2 shards are 2 × 6
    assert tsqr.cost(11, 3, 2)[1] == 2 * (2 * 6 * 9 - 18) + 90 + 2 * 4 * 6 * 3 + 72


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not control.readings(CELL, "control", 2**35 + 3, 2)["within"]
