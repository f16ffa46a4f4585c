"""The check catches the faults a cell can have, and the control.

Each test drives the rest of a run on the CPU (past the look for a card),
at a small size, with the timed path broken underneath, and sees
``correct`` come out false: a step that returns its state unchanged, half
of a batch left out, an answer altered where it is produced.  (No cell
spans chips, so no exchange between chips can be left out.)  The control,
the reference one precision step below the configuration's in the
program's place, fails too.  On the card the control runs at each cell's
own size."""
import numpy as np
import pytest
import torch

from qrbench import control, run

from .cells import small_cell

ELLIPSE = ["ellipse-n500k", "ellipse-b100-n500"]
BANDED = ["banded-c3-refactor"]


def run_small(workload):
    bench, config, mix = small_cell(workload)
    res, checks = run.run_cell(workload, 2**33 + 5, 0.2, False, device="cpu", bench=bench,
                               config=config, mix=mix)
    return res, checks


@pytest.mark.parametrize("workload", ELLIPSE + BANDED)
def test_sound_program_is_correct(workload):
    res, _ = run_small(workload)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("workload", ELLIPSE)
def test_step_that_returns_its_state_unchanged(workload, monkeypatch):
    from qrkit_tpu_torch.examples import ellipse

    monkeypatch.setattr(ellipse, "_damped_step_aux",
                        lambda params, res, lam, pts, **kw: torch.zeros_like(params))
    res, checks = run_small(workload)
    assert not res["correct"] and checks["param_gap"][0] > checks["param_gap"][1]


def test_half_of_the_batch_left_out(monkeypatch):
    from qrkit_tpu_torch.examples import ellipse
    from qrkit_tpu_torch.lm import LMResult

    whole = ellipse.fit_ellipse_batch

    def half(pts_batch, config=None, dtype=torch.float64, device=None):
        h = len(pts_batch) // 2
        r = whole(pts_batch[:h], config, dtype, device)
        rest = np.stack([ellipse.initial_params_np(p) for p in pts_batch[h:]])
        cat = lambda a, b: np.concatenate([np.asarray(a), b])
        return LMResult(cat(r.x, rest), cat(r.cost, np.zeros(len(rest))),
                        cat(r.iterations, np.zeros(len(rest), int)),
                        cat(r.converged, np.ones(len(rest), bool)),
                        cat(r.lambda_final, np.zeros(len(rest))))

    monkeypatch.setattr(ellipse, "fit_ellipse_batch", half)
    res, _ = run_small("ellipse-b100-n500")
    assert not res["correct"]


@pytest.mark.parametrize("workload", ELLIPSE)
def test_answer_altered_where_produced(workload, monkeypatch):
    from qrkit_tpu_torch import lm

    fetch = lm._unpack

    def altered(host, B, n):
        x, *rest = fetch(host, B, n)
        x = x.copy()
        x[0, 0] += 1e-2
        return (x, *rest)

    monkeypatch.setattr(lm, "_unpack", altered)
    res, checks = run_small(workload)
    assert not res["correct"] and checks["latent_gap"][0] > checks["latent_gap"][1]


@pytest.mark.parametrize("workload", BANDED)
def test_solution_altered_where_produced(workload, monkeypatch):
    from qrkit_tpu_torch.solvers import SegmentedBandedQR

    whole = SegmentedBandedQR.solve

    def altered(self, b):
        x = whole(self, b)
        x.view(-1)[0] += 1e-3 * float(x.abs().max())
        return x

    monkeypatch.setattr(SegmentedBandedQR, "solve", altered)
    res, _ = run_small(workload)
    assert not res["correct"]


@pytest.mark.parametrize("workload", ELLIPSE + BANDED)
def test_control_fails(workload):
    bench, config, mix = small_cell(workload)
    got = control.readings(workload, "control", 2**35 + 1, 3, "cpu", config, mix, bench)
    assert not got["within"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ELLIPSE + BANDED)
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = control.readings(workload, "control", 2**35 + 3, 4)
    assert not got["within"]
