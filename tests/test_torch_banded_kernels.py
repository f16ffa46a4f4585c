"""The banded kernels' plain PyTorch versions against the Pallas kernels
(interpret mode), the general chain recurrence against the reference's XLA
chain, and the CUDA kernels against the plain versions.

The JAX side gets its own layouts (segment axis last, padded to 1024 lanes;
the sequential chain in X-layout, padded to whole ``nsub`` groups); the
port's operands are the same numbers, chain index first.  Tolerance: rtol
1e-10 with atol 1e-12·max|reference| (fp64).

The CUDA cases carry the ``cuda`` marker and skip without a card; on a
GPU machine without JAX they run alone with ``python -m pytest --noconftest
-m cuda tests/test_torch_banded_kernels.py``.  Besides the main paths'
shapes they walk the kernels' edges: panel heights on both sides of each
32-row register slot (4 … 88 rows), widths 1 … 32 (the register kernels'
padded widths and the shared-memory kernel), first-step cuts that differ
from the body's, interleaved inactive steps, exactly zero columns (τ = 0),
and the W apply with nothing written back (h = 0) and with every window
position written back (h at the window's far edge).
"""
import numpy as np
import pytest
import torch

from qrkit_tpu_torch import profiling
from qrkit_tpu_torch.ops import banded as bk

NPAD = 1024  # the Pallas kernels' segment-axis granule (pallas_banded.SEG_STEP)


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = 1e-12 * max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=atol)


def _panels(rng, *lead, ma, mc):
    return rng.uniform(0.5, 5.0, size=(*lead, ma, mc))


def _to_soa(a, npad=NPAD):
    """[S, L, ...] → the reference's [L, prod(...), npad] (segments last, padded)."""
    S, L = a.shape[:2]
    flat = a.reshape(S, L, -1).transpose(1, 2, 0)
    out = np.zeros(flat.shape[:2] + (npad,))
    out[..., :S] = flat
    return out


def _from_soa(a, S, shape):
    """The reference's [L, e, npad] → [S, L, *shape]."""
    return a[..., :S].transpose(2, 0, 1).reshape((S, a.shape[0]) + shape)


def test_segment_chains_plain_matches_pallas():
    import jax.numpy as jnp
    from qrkit_tpu.ops.pallas_banded import pallas_segment_chains_soa

    rng = np.random.default_rng(1)
    S, L, ma, mc, mca, me, ci, ci0_rest = 5, 6, 10, 4, 4, 3, 2, 1
    panels = _panels(rng, S, L, ma=ma, mc=mc)
    act = np.ones((S, L))
    act[3, 4:] = 0.0  # inactive tail steps: zeros out, carry passes through
    act[4, 3:] = 0.0
    y, tau, v = bk.segment_chains(
        torch.as_tensor(panels), torch.as_tensor(act), mca=mca, me=me, ci=ci, ci0_rest=ci0_rest
    )
    act_soa = np.zeros((L, 1, NPAD))
    act_soa[:, 0, :S] = act.T
    jy, jt, jv = pallas_segment_chains_soa(
        jnp.asarray(_to_soa(panels)), jnp.asarray(act_soa),
        ma=ma, mc=mc, mca=mca, me=me, ci=ci, ci0_rest=ci0_rest, interpret=True,
    )
    assert_close(y.numpy(), _from_soa(np.asarray(jy), S, (ma, mc)))
    assert_close(tau.numpy(), _from_soa(np.asarray(jt), S, (mc,)))
    assert_close(v.numpy(), _from_soa(np.asarray(jv), S, (me, mc)))
    assert not v[3, 4:].any() and not y[4, 3:].any()


def test_chain_qr_plain_matches_pallas():
    import jax.numpy as jnp
    from qrkit_tpu.ops.pallas_banded import pallas_chain_qr

    rng = np.random.default_rng(2)
    nb, nbp, ma, mc, mca, me, ci, ci0 = 13, 16, 10, 4, 4, 3, 2, 1
    panels = _panels(rng, nbp, ma=ma, mc=mc)
    act = np.zeros(nbp)
    act[:nb] = 1.0  # padded to whole nsub groups of 8, as the reference does
    y, tau, v = bk.chain_qr(
        torch.as_tensor(panels), torch.as_tensor(act), mca=mca, me=me, ci=ci, ci0=ci0
    )
    jy, jt, jv = pallas_chain_qr(
        jnp.asarray(panels.transpose(0, 2, 1)), jnp.asarray(act),
        ma=ma, mc=mc, mca=mca, me=me, ci=ci, ci0=ci0, nsub=8, interpret=True,
    )
    assert_close(y.numpy(), np.asarray(jy).transpose(0, 2, 1))
    assert_close(tau.numpy(), np.asarray(jt))
    assert_close(v.numpy(), np.asarray(jv).transpose(0, 2, 1))
    assert not tau[nb:].any()


def test_chain_qr_plain_matches_pallas_4x1():
    """The geometry of the banded ellipse stack (``BandedBlockedQR(3, 1, 0,
    1)`` on the damped Jacobian): 4×1 panels, a one-row carry, mc = 1."""
    import jax.numpy as jnp
    from qrkit_tpu.ops.pallas_banded import pallas_chain_qr

    rng = np.random.default_rng(6)
    nb, ma, mc, mca, me, ci, ci0 = 80, 4, 1, 1, 1, 1, 1
    panels = _panels(rng, nb, ma=ma, mc=mc)
    panels[:, 0] = 0.0  # the carry row, as the shifted gather map leaves it
    act = np.ones(nb)
    y, tau, v = bk.chain_qr(
        torch.as_tensor(panels), torch.as_tensor(act), mca=mca, me=me, ci=ci, ci0=ci0
    )
    jy, jt, jv = pallas_chain_qr(
        jnp.asarray(panels.transpose(0, 2, 1)), jnp.asarray(act),
        ma=ma, mc=mc, mca=mca, me=me, ci=ci, ci0=ci0, nsub=8, interpret=True,
    )
    assert_close(y.numpy(), np.asarray(jy).transpose(0, 2, 1))
    assert_close(tau.numpy(), np.asarray(jt))
    assert_close(v.numpy(), np.asarray(jv).transpose(0, 2, 1))


def test_segment_apply_w_plain_matches_pallas():
    """Fed with the maps of the reference's plan on the tall-block
    miniature, where its W-apply gate fires."""
    import jax.numpy as jnp
    from qrkit_tpu.ops.pallas_banded import pallas_segment_apply_w
    from qrkit_tpu.solvers import SegmentedBandedQR as JSegmented

    from generators import tall_banded_matrix

    rng = np.random.default_rng(3)
    jq = JSegmented(suggested_block_cols=4, segment_blocks=8, use_pallas=True)
    jq.analyze_pattern(tall_banded_matrix(64, rng, br=10, bc=4, ov=2))
    st = jq._p2w["statics"]
    S, L = jq.S, jq.L
    ma, mc, mca, ko, kg, h, wrows = (st[k] for k in ("ma", "mc", "mca", "ko", "kg", "h", "wrows"))
    y = np.tril(rng.normal(size=(S, L, ma, mc)), -1)
    y[:, :, np.arange(mc), np.arange(mc)] = 1.0  # unit-diagonal reflectors
    tau = rng.uniform(0.0, 2.0, size=(S, L, mc))
    w = rng.normal(size=(S, L, ma, ko))
    ab = np.array(jq._p2w["ab"])
    wq = bk.segment_apply_w(
        torch.as_tensor(y), torch.as_tensor(tau), torch.as_tensor(w),
        torch.as_tensor(ab, dtype=torch.int32), mca=mca, h=h, wrows=wrows,
    )
    # the reference walks the ko columns kg at a time: w_soa [L, ko/kg, ma*kg, npad]
    ncg = ko // kg
    w_grp = w.reshape(S, L, ma, ncg, kg).transpose(0, 1, 3, 2, 4).reshape(S, L, ncg * ma * kg)
    jwq = pallas_segment_apply_w(
        jnp.asarray(_to_soa(y)), jnp.asarray(_to_soa(tau)),
        jnp.asarray(_to_soa(w_grp).reshape(L, ncg, ma * kg, NPAD)), jnp.asarray(ab),
        ma=ma, mc=mc, mca=mca, ko=ko, kg=kg, h=h, wrows=wrows, interpret=True,
    )
    want = np.asarray(jwq)[..., :S].reshape(L, ncg, ma, kg, S).transpose(4, 0, 2, 1, 3)
    assert_close(wq.numpy(), want.reshape(S, L, ma, ko))


def test_chain_factorize_matches_xla_chain():
    """The general recurrence (per-step column increments, inactive steps)
    against the reference's vmapped XLA chain."""
    import jax.numpy as jnp
    from qrkit_tpu.solvers.segmented_factorize import _vmapped_chain

    from qrkit_tpu_torch.ops.householder import build_t_factor

    rng = np.random.default_rng(4)
    B, n, ma, mc, mca, me = 3, 7, 9, 4, 3, 2
    shifted = _panels(rng, B, n, ma=ma, mc=mc)
    col_inc = rng.integers(0, mc + 1, size=(B, n))
    active = np.ones((B, n), dtype=bool)
    active[2, 5:] = False
    y, taus, v = bk.chain_factorize(
        torch.as_tensor(shifted), torch.as_tensor(col_inc), torch.as_tensor(active), mca, me
    )
    _, (jy, jt, jv) = _vmapped_chain(
        jnp.zeros((B, mca, mc)), jnp.asarray(shifted), jnp.asarray(col_inc, dtype=jnp.int32),
        jnp.asarray(active), max_carry=mca, max_emit=me,
    )
    assert_close(y.numpy(), np.asarray(jy))
    assert_close(v.numpy(), np.asarray(jv))
    assert_close(build_t_factor(y, taus).numpy(), np.asarray(jt))


@pytest.mark.parametrize(
    "case,match",
    [
        ("dtype", "float32 or float64"),
        ("act_shape", "does not match"),
        ("increment", "outside"),
        ("shared_memory", "shared memory"),
        ("ab_dtype", "int32"),
    ],
)
def test_wrappers_reject_bad_operands(case, match):
    p = torch.ones((2, 3, 6, 4), dtype=torch.float64)
    act = torch.ones((2, 3), dtype=torch.float64)
    kw = dict(mca=2, me=2, ci=2, ci0_rest=2)
    with pytest.raises((TypeError, ValueError), match=match):
        if case == "dtype":
            bk.segment_chains(p.long(), act, **kw)
        elif case == "act_shape":
            bk.segment_chains(p, act[:, :2], **kw)
        elif case == "increment":
            bk.chain_qr(p[0], act[0], mca=2, me=2, ci=5, ci0=0)
        elif case == "shared_memory":
            big = torch.ones((1, 2000, 32), dtype=torch.float64)
            bk.chain_qr(big, torch.ones(1, dtype=torch.float64), mca=8, me=8, ci=4, ci0=4)
        else:
            tau = torch.ones((2, 3, 4), dtype=torch.float64)
            w = torch.ones((2, 3, 6, 2), dtype=torch.float64)
            bk.segment_apply_w(p, tau, w, torch.zeros((3, 2)), mca=2, h=4, wrows=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    """B3, B4, B5 against their plain versions on the card (ci0 != ci,
    inactive steps); reductions add in another order, so within fp32 rtol
    1e-4 (atol 1e-5·max) or fp64 rtol 1e-10 (atol 1e-12·max)."""
    rtol, atol_rel = _tolerance(dtype)

    def close(got, want):
        for g, w in zip(got, want):
            torch.testing.assert_close(
                g, w, rtol=rtol, atol=atol_rel * w.abs().max().item(), check_dtype=True
            )

    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda_device)  # noqa: E731
    profiling.reset_launch_counts()
    S, L, ma, mc, mca, me = 7, 9, 48, 8, 8, 8
    panels = t(_panels(rng, S, L, ma=ma, mc=mc))
    act = np.ones((S, L))
    act[6, 5:] = 0.0
    act = t(act)
    kw = dict(mca=mca, me=me, ci=4, ci0_rest=0)
    out = bk.segment_chains(panels, act, **kw)
    close(out, bk._segment_chains_plain(panels, act, **kw))
    y, tau, _ = out
    ab = torch.as_tensor(
        np.stack([np.arange(L) * 4, 40 + np.arange(L) * 40], axis=1), dtype=torch.int32,
        device=cuda_device,
    )
    w = t(rng.normal(size=(S, L, ma, 8)))
    wkw = dict(mca=mca, h=40, wrows=80)
    close((bk.segment_apply_w(y, tau, w, ab, **wkw),), (bk._segment_apply_w_plain(y, tau, w, ab, **wkw),))
    chain = t(_panels(rng, 40, ma=88, mc=32))
    cact = t(np.ones(40))
    ckw = dict(mca=32, me=28, ci=28, ci0=24)
    close(bk.chain_qr(chain, cact, **ckw), bk._chain_qr_plain(chain, cact, **ckw))
    counts = profiling.launch_counts()
    assert (counts["banded_segment_chains"], counts["banded_apply_w"], counts["banded_chain_qr"]) == (1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("nb", [80, 2000])
def test_cuda_chain_qr_4x1_matches_plain(cuda_device, dtype, nb):
    """B5 at mc = 1 (one warp, a one-column loop, a one-row carry): the
    banded ellipse stack's 4×1 chain, one launch."""
    rtol, atol_rel = (1e-10, 1e-12) if dtype == torch.float64 else (1e-4, 1e-5)
    rng = np.random.default_rng(8)
    panels = _panels(rng, nb, ma=4, mc=1)
    panels[:, 0] = 0.0
    p = torch.as_tensor(panels, dtype=dtype, device=cuda_device)
    act = torch.ones(nb, dtype=dtype, device=cuda_device)
    kw = dict(mca=1, me=1, ci=1, ci0=1)
    profiling.reset_launch_counts()
    out = bk.chain_qr(p, act, **kw)
    torch.cuda.synchronize()
    assert profiling.launch_counts()["banded_chain_qr"] == 1
    for g, w in zip(out, bk._chain_qr_plain(p, act, **kw)):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol_rel * w.abs().max().item())


EDGE_MA = [4, 31, 32, 33, 48, 64, 65, 88]
EDGE_MC = [1, 7, 8, 9, 32]
APPLY_EDGES = [  # (ma, mc, mca, ko)
    (4, 1, 1, 2), (33, 7, 5, 3), (48, 8, 8, 8), (65, 9, 10, 33), (88, 32, 32, 8),
    (56, 16, 8, 16), (32, 32, 16, 32), (96, 8, 8, 17), (20, 4, 4, 32),
]


def _tolerance(dtype):
    """Kernel against plain version: the reductions add in another order."""
    return (1e-10, 1e-12) if dtype == torch.float64 else (1e-4, 1e-5)


def _assert_outputs_close(got, want, dtype):
    rtol, atol_rel = _tolerance(dtype)
    for g, w in zip(got, want):
        atol = atol_rel * max(w.abs().max().item(), 1e-300)
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, check_dtype=True)


def _edge_panels(rng, lead, ma, mc):
    """Random panels whose first step (no carry yet) has an exactly zero
    column 0: x0 = 0 and sigma = 0, a degenerate reflector (tau = 0)."""
    p = _panels(rng, *lead, ma=ma, mc=mc)
    p[(0,) * len(lead)][:, 0] = 0.0
    return p


def _edge_act(shape):
    """Every third step of each chain inactive, staggered by chain."""
    act = np.ones(shape)
    flat = act.reshape(-1, shape[-1])
    for s in range(flat.shape[0]):
        flat[s, (s + 1) % 3 :: 3] = 0.0
    flat[0, 0] = 1.0  # keep the zero-column step active
    return act


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mc", EDGE_MC)
@pytest.mark.parametrize("ma", EDGE_MA)
def test_cuda_segment_chains_edges(cuda_device, ma, mc, dtype):
    """B3 against its plain version at the edge geometries: chains >= 1 cut
    their first step at ci0_rest != ci, inactive steps interleaved, zero
    columns, one launch."""
    rng = np.random.default_rng(100 + ma * 40 + mc)
    S, L = 3, 7
    mca = max(1, min(ma - 1, mc)) if ma > 1 else 1
    me = min(ma, mc)
    ci = max(1, mc // 2)
    ci0_rest = ci - 1
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda_device)  # noqa: E731
    panels, act = t(_edge_panels(rng, (S, L), ma, mc)), t(_edge_act((S, L)))
    kw = dict(mca=mca, me=me, ci=ci, ci0_rest=ci0_rest)
    profiling.reset_launch_counts()
    out = bk.segment_chains(panels, act, **kw)
    torch.cuda.synchronize()
    assert profiling.launch_counts()["banded_segment_chains"] == 1
    _assert_outputs_close(out, bk._segment_chains_plain(panels, act, **kw), dtype)
    assert not out[1][0, 0, 0].item()  # the zero column's tau
    assert not out[2][act == 0].any()  # inactive steps emit zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mc", EDGE_MC)
@pytest.mark.parametrize("ma", EDGE_MA)
def test_cuda_chain_qr_edges(cuda_device, ma, mc, dtype):
    """B5 against its plain version at the edge geometries, first step cut
    at ci0 != ci, inactive steps interleaved, a zero column."""
    rng = np.random.default_rng(200 + ma * 40 + mc)
    nb = 11
    mca = max(1, min(ma, mc + 1))
    me = min(ma, mc)
    ci, ci0 = mc, max(0, mc - 1)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda_device)  # noqa: E731
    panels, act = t(_edge_panels(rng, (nb,), ma, mc)), t(_edge_act((nb,)))
    kw = dict(mca=mca, me=me, ci=ci, ci0=ci0)
    out = bk.chain_qr(panels, act, **kw)
    torch.cuda.synchronize()
    _assert_outputs_close(out, bk._chain_qr_plain(panels, act, **kw), dtype)
    assert not out[1][0, 0].item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("h_at", ["zero", "edge"])
@pytest.mark.parametrize("ma,mc,mca,ko", APPLY_EDGES)
def test_cuda_apply_w_edges(cuda_device, ma, mc, mca, ko, h_at, dtype):
    """B4 against its plain version: nothing written back (h = 0), or h at
    the window's far edge so every window position is written back; window
    starts that move by varying strides; Y and tau from B3's plain version
    (zero columns, inactive steps).  The register kernel at ko > 8 (four
    columns a warp, ragged last warps) and at its heaviest widths (mc 16
    and 32) as well as the shared-memory kernel (ko 33, fp64 at wide mc)."""
    rng = np.random.default_rng(300 + ma + mc + ko)
    S, L = 3, 6
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda_device)  # noqa: E731
    panels, act = t(_edge_panels(rng, (S, L), ma, mc)), t(_edge_act((S, L)))
    y, tau, _ = bk._segment_chains_plain(panels, act, mca=mca, me=min(ma, mc), ci=1, ci0_rest=0)
    a = np.cumsum(rng.integers(0, 3, size=L))
    b = a + mca + rng.integers(0, 3, size=L)
    h = 0 if h_at == "zero" else int((b + ma - mca).max())
    wrows = h + max(ma - mca, mca)
    ab = torch.as_tensor(np.stack([a, b], 1), dtype=torch.int32, device=cuda_device)
    w = t(rng.normal(size=(S, L, ma, ko)))
    kw = dict(mca=mca, h=h, wrows=wrows)
    out = bk.segment_apply_w(y, tau, w, ab, **kw)
    torch.cuda.synchronize()
    _assert_outputs_close((out,), (bk._segment_apply_w_plain(y, tau, w, ab, **kw),), dtype)
