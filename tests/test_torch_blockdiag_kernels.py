"""The block-diagonal kernels' plain PyTorch versions against the Pallas
kernels (interpret mode), and the CUDA kernels against the plain versions.

The JAX side is fed the ``_pad_soa_identity``-padded operand its kernels
require, and its pad columns are dropped before comparing.  Tolerances:
packed R rtol/atol 1e-12, x atol 1e-9 (as tests/test_pallas_blockdiag_class.py).

The CUDA case carries the ``cuda`` marker and skips without a card.  JAX is
imported inside the helpers, so on a GPU machine without JAX the CUDA case
runs alone with ``python -m pytest --noconftest -m cuda
tests/test_torch_blockdiag_kernels.py``.

The device tests at the end need no card: a CPU tensor that reports
``cuda:N`` takes a wrapper's kernel path, and the launchers are swapped for
recorders, so they show which device ordinal reaches each launcher.
"""
import numpy as np
import pytest
import torch

from qrkit_tpu_torch import profiling
from qrkit_tpu_torch.ops import _build
from qrkit_tpu_torch.ops import banded as bk
from qrkit_tpu_torch.ops import blockdiag as bd

# config 2's 7x2, small and square shapes, and the bundle's 19x3 point blocks
SHAPES = [(7, 2), (2, 1), (3, 3), (8, 8), (16, 4), (19, 3)]
SHAPE_IDS = [f"{br}x{bc}" for br, bc in SHAPES]
# batch sizes that take every CTA size the launchers pick (32 ... 256 threads)
CUDA_NS = (1, 31, 4225, 10_007, 20_000, 200_003)


def _operands(seed, n, br, bc):
    """SoA blocks uniform(0.5, 5), block 0 with a first column that is zero
    below a nonzero diagonal (the degenerate sigma <= 0 path), rhs normal."""
    rng = np.random.default_rng(seed)
    blocks = rng.uniform(0.5, 5.0, size=(n, br, bc))
    blocks[0, 1:, 0] = 0.0
    a_soa = np.ascontiguousarray(blocks.transpose(1, 2, 0).reshape(br * bc, n))
    return blocks, a_soa, rng.normal(size=(br, n))


def _jax_lstsq_soa(a_soa, b_soa, bc, b_scale=None, stepnorm=False):
    import jax.numpy as jnp
    from qrkit_tpu.ops.pallas_blockdiag import (
        _pad_soa_identity,
        _pad_soa_zero,
        pallas_block_diagonal_lstsq_soa,
    )

    n = a_soa.shape[1]
    out = pallas_block_diagonal_lstsq_soa(
        _pad_soa_identity(jnp.asarray(a_soa), bc, n),
        _pad_soa_zero(jnp.asarray(b_soa), n),
        interpret=True,
        b_scale=None if b_scale is None else jnp.asarray(b_scale),
        stepnorm=stepnorm,
    )
    if stepnorm:  # the identity pad blocks see a zero rhs: they add exactly 0
        return np.asarray(out[0])[:, :n], float(out[1])
    return np.asarray(out)[:, :n]


def _jax_qr_r_soa(a_soa, br, bc):
    import jax.numpy as jnp
    from qrkit_tpu.ops.pallas_blockdiag import _pad_soa_identity, pallas_block_diagonal_qr_r_soa

    n = a_soa.shape[1]
    r = pallas_block_diagonal_qr_r_soa(
        _pad_soa_identity(jnp.asarray(a_soa), bc, n), br, interpret=True
    )
    return np.asarray(r)[:, :n]


@pytest.mark.parametrize("br,bc", SHAPES, ids=SHAPE_IDS)
def test_lstsq_plain_matches_pallas(br, bc):
    _, a_soa, b_soa = _operands(1, 37, br, bc)
    x = bd.block_diagonal_lstsq_soa(torch.as_tensor(a_soa), torch.as_tensor(b_soa))
    assert x.shape == (bc, 37)
    np.testing.assert_allclose(x.numpy(), _jax_lstsq_soa(a_soa, b_soa, bc), rtol=0, atol=1e-9)


@pytest.mark.parametrize("br,bc", SHAPES, ids=SHAPE_IDS)
def test_qr_r_plain_matches_pallas(br, bc):
    _, a_soa, _ = _operands(2, 37, br, bc)
    r = bd.block_diagonal_qr_r_soa(torch.as_tensor(a_soa), br)
    assert r.shape == (bc * (bc + 1) // 2, 37)
    np.testing.assert_allclose(r.numpy(), _jax_qr_r_soa(a_soa, br, bc), rtol=1e-12, atol=1e-12)


OPTIONS = [(True, False), (False, True), (True, True)]
OPTION_IDS = ["b_scale", "stepnorm", "b_scale+stepnorm"]


@pytest.mark.parametrize("scaled,stepnorm", OPTIONS, ids=OPTION_IDS)
def test_lstsq_options_plain_matches_pallas(scaled, stepnorm):
    """B1's b_scale (x scaled after the back-substitution) and stepnorm (Σx²
    over every block) against the Pallas kernel's options."""
    _, a_soa, b_soa = _operands(6, 37, 7, 2)
    scale = -2.5 if scaled else None
    out = bd.block_diagonal_lstsq_soa(
        torch.as_tensor(a_soa), torch.as_tensor(b_soa),
        b_scale=None if scale is None else torch.tensor(scale, dtype=torch.float64),
        stepnorm=stepnorm,
    )
    want = _jax_lstsq_soa(a_soa, b_soa, 2, b_scale=scale, stepnorm=stepnorm)
    if stepnorm:
        (x, sn), (want, want_sn) = out, want
        assert sn.dim() == 0
        np.testing.assert_allclose(float(sn), want_sn, rtol=1e-12)
        np.testing.assert_allclose(float(sn), float((x * x).sum()), rtol=1e-14)
    else:
        x = out
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-9)
    plain = bd.block_diagonal_lstsq_soa(torch.as_tensor(a_soa), torch.as_tensor(b_soa))
    assert torch.equal(x, plain * scale if scaled else plain)  # linearity: exact


def test_lstsq_rejects_bad_b_scale():
    a = torch.ones((14, 5), dtype=torch.float64)
    b = torch.ones((7, 5), dtype=torch.float64)
    for bad in (torch.tensor(2.0), torch.ones(2, dtype=torch.float64)):
        with pytest.raises(ValueError, match="b_scale"):
            bd.block_diagonal_lstsq_soa(a, b, b_scale=bad)


def test_aos_wrappers_match_pallas_aos():
    import jax.numpy as jnp
    from qrkit_tpu.ops.pallas_blockdiag import (
        pallas_block_diagonal_lstsq,
        pallas_block_diagonal_qr_r,
    )

    blocks, _, b_soa = _operands(3, 21, 7, 2)
    b = np.concatenate([b_soa.T.reshape(-1), [0.5, -1.0]])  # ignored tail rows
    x = bd.block_diagonal_lstsq(torch.as_tensor(blocks), torch.as_tensor(b))
    want = pallas_block_diagonal_lstsq(jnp.asarray(blocks), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=0, atol=1e-9)
    r = bd.block_diagonal_qr_r(torch.as_tensor(blocks))
    want_r = pallas_block_diagonal_qr_r(jnp.asarray(blocks), interpret=True)
    np.testing.assert_allclose(r.numpy(), np.asarray(want_r), rtol=1e-12, atol=1e-12)


def test_plain_solves_least_squares():
    """Independent of JAX: the plain version's x is the per-block lstsq."""
    blocks, a_soa, b_soa = _operands(4, 9, 7, 2)
    x = bd.block_diagonal_lstsq_soa(torch.as_tensor(a_soa), torch.as_tensor(b_soa)).numpy()
    for k in range(9):
        want, *_ = np.linalg.lstsq(blocks[k], b_soa[:, k], rcond=None)
        np.testing.assert_allclose(x[:, k], want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize(
    "a_shape,b_shape,dtype,match",
    [
        ((14, 5), (7, 5), torch.int64, "float32 or float64"),
        ((14, 5), (7, 4), torch.float64, "do not match"),
        ((10, 5), (2, 5), torch.float64, "unsupported block shape"),
        ((65, 5), (65, 5), torch.float64, "unsupported block shape"),
    ],
    ids=["dtype", "batch", "landscape", "too_many_entries"],
)
def test_wrapper_rejects_bad_operands(a_shape, b_shape, dtype, match):
    a = torch.ones(a_shape, dtype=dtype)
    b = torch.ones(b_shape, dtype=dtype)
    with pytest.raises((TypeError, ValueError), match=match):
        bd.block_diagonal_lstsq_soa(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    """Each CUDA kernel against its plain version on the card, every shape,
    ragged batch sizes that take every launch geometry; built with
    --fmad=false, the two agree to the bit."""
    profiling.reset_launch_counts()
    for br, bc in SHAPES:
        for n in CUDA_NS:
            _, a_soa, b_soa = _operands(5, n, br, bc)
            a = torch.as_tensor(a_soa, dtype=dtype, device=cuda_device)
            b = torch.as_tensor(b_soa, dtype=dtype, device=cuda_device)
            x = bd.block_diagonal_lstsq_soa(a, b)
            r = bd.block_diagonal_qr_r_soa(a, br)
            torch.cuda.synchronize()
            assert torch.equal(x, bd._lstsq_soa_plain(a, b))
            assert torch.equal(r, bd._qr_r_soa_plain(a, br))
    n_cases = len(SHAPES) * len(CUDA_NS)
    counts = profiling.launch_counts()
    assert (counts.pop("blockdiag_lstsq"), counts.pop("blockdiag_qr_r")) == (n_cases, n_cases)
    assert not any(counts.values())  # no banded kernel on this path


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("scaled,stepnorm", OPTIONS, ids=OPTION_IDS)
def test_cuda_lstsq_options_match_plain(cuda_device, dtype, scaled, stepnorm):
    """B1 with b_scale / stepnorm against the plain version on the card: x
    to the bit (the scale multiplies x after the back-substitution in both),
    Σx² to rounding (the CTA tree adds in another order than torch's sum)."""
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    profiling.reset_launch_counts()
    ncalls = 0
    for br, bc in SHAPES:
        for n in CUDA_NS:
            _, a_soa, b_soa = _operands(7, n, br, bc)
            a = torch.as_tensor(a_soa, dtype=dtype, device=cuda_device)
            b = torch.as_tensor(b_soa, dtype=dtype, device=cuda_device)
            scale = torch.tensor(-1.75, dtype=dtype, device=cuda_device) if scaled else None
            out = bd.block_diagonal_lstsq_soa(a, b, b_scale=scale, stepnorm=stepnorm)
            ncalls += 1
            torch.cuda.synchronize()
            ref = bd._lstsq_soa_plain(a, b, scale, stepnorm)
            if stepnorm:
                assert torch.equal(out[0], ref[0])
                torch.testing.assert_close(out[1], ref[1], rtol=rtol, atol=0)
            else:
                assert torch.equal(out, ref)
    assert profiling.launch_counts()["blockdiag_lstsq"] == ncalls


class _OnCuda1(torch.Tensor):
    """A CPU tensor that reports cuda:1, so a wrapper takes its kernel path."""

    @property
    def device(self):
        return torch.device("cuda", 1)


class _OnCuda0(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def launch_recorder(monkeypatch):
    """Every launcher swapped for a recorder of (name, args); the stream of
    cuda:N reads as 1000 + N.  The launch counters are restored after."""
    calls = []

    class Library:
        def __getattr__(self, name):
            def record(*args):
                calls.append((name, args))
                return 0

            record.__name__ = name
            return record

    monkeypatch.setattr(_build, "load", lambda br, bc: Library())
    monkeypatch.setattr(_build, "load_banded", lambda: Library())
    monkeypatch.setattr(_build, "current_stream", lambda device: 1000 + device)
    for fn in profiling._KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    _build.blockdiag_launcher.cache_clear()
    _build.banded_launcher.cache_clear()
    yield calls
    _build.blockdiag_launcher.cache_clear()
    _build.banded_launcher.cache_clear()


def _wrapper_cases():
    """(kernel, wrapper call on operands, operands, launcher name); every
    operand a float64 CPU tensor but ``ab`` (int32)."""
    rng = np.random.default_rng(9)
    f = lambda *shape: torch.as_tensor(rng.uniform(0.5, 5.0, size=shape))  # noqa: E731
    ab = torch.tensor([[0, 2], [1, 3], [2, 4]], dtype=torch.int32)
    chain = dict(mca=2, me=2, ci=1)
    return [
        ("blockdiag_lstsq", lambda a, b: bd.block_diagonal_lstsq_soa(a, b), [f(14, 5), f(7, 5)],
         "qrk_blockdiag_lstsq_f64"),
        ("blockdiag_lstsq", lambda a, b, s: bd.block_diagonal_lstsq_soa(a, b, b_scale=s, stepnorm=True),
         [f(57, 5), f(19, 5), f(1)], "qrk_blockdiag_lstsq_opt_f64"),
        ("blockdiag_qr_r", lambda a: bd.block_diagonal_qr_r_soa(a, 19), [f(57, 5)], "qrk_blockdiag_qr_r_f64"),
        ("banded_segment_chains", lambda p, act: bk.segment_chains(p, act, ci0_rest=0, **chain),
         [f(2, 3, 6, 2), f(2, 3)], "qrk_banded_segment_chains_f64"),
        ("banded_chain_qr", lambda p, act: bk.chain_qr(p, act, ci0=0, **chain), [f(3, 6, 2), f(3)],
         "qrk_banded_chain_qr_f64"),
        ("banded_apply_w", lambda y, t, w, ab: bk.segment_apply_w(y, t, w, ab, mca=2, h=6, wrows=10),
         [f(2, 3, 6, 2), f(2, 3, 2), f(2, 3, 6, 4), ab], "qrk_banded_apply_w_f64"),
    ]


_CASE_IDS = ["lstsq", "lstsq_options", "qr_r", "segment_chains", "chain_qr", "apply_w"]


@pytest.mark.parametrize("case", range(6), ids=_CASE_IDS)
def test_kernels_launch_on_the_operands_card(launch_recorder, case):
    """An operand on cuda:1 reaches its launcher with ordinal 1 and cuda:1's
    stream; the wrapper counts the launch."""
    kernel, call, operands, launcher = _wrapper_cases()[case]
    call(*(t.as_subclass(_OnCuda1) for t in operands))
    ((name, args),) = launch_recorder
    assert name == launcher and args[0] == 1 and args[-1] == 1001
    assert profiling.launch_counts()[kernel] == 1


@pytest.mark.parametrize("case", [0, 1, 3, 4, 5], ids=[_CASE_IDS[i] for i in (0, 1, 3, 4, 5)])
def test_kernels_refuse_operands_on_two_cards(launch_recorder, case):
    """Operands split over cuda:1 and cuda:0 raise before any launch (B2
    takes one operand)."""
    _, call, operands, _ = _wrapper_cases()[case]
    on = [t.as_subclass(_OnCuda1) for t in operands]
    on[-1] = operands[-1].as_subclass(_OnCuda0)
    with pytest.raises(ValueError):
        call(*on)
    assert not launch_recorder and not any(profiling.launch_counts().values())


def _flat(out):
    return [t for o in out for t in _flat(o)] if isinstance(out, (tuple, list)) else [out]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(6), ids=_CASE_IDS)
def test_cuda_kernels_on_a_second_card(cuda_device, case):
    """With cuda:0 current, each kernel runs on a cuda:1 operand's card,
    gives the bits it gives on cuda:0, and leaves cuda:0 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _, call, operands, _ = _wrapper_cases()[case]
    torch.cuda.set_device(0)
    want = _flat(call(*(t.to("cuda:0") for t in operands)))
    got = _flat(call(*(t.to("cuda:1") for t in operands)))
    assert torch.cuda.current_device() == 0
    assert all(t.device == torch.device("cuda", 1) for t in got)
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w.cpu())
