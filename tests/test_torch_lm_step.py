"""The lane-major damped LM step as kernel K3 (``ops.lm_step``).

On the CPU the wrapper ``damped_step_lane_major`` runs its plain version,
the same tiled algorithm as the kernels: the per-point pass, one partial
``[R | Qᵀy]`` of the bottom panel per tile of points, the reduction levels
over groups of partials, the finish with the √λ·I tail and the per-point
back-substitution.  Here, at small tiles so that every stage runs (a
level of K3b once the points make more than a group of partials), it is
held against ``qrkit_tpu.functional.lm_damped_step_blockdiag``
(one QR over every lane, jitted on the CPU) at fp64 rtol 1e-10 (atol
1e-10), the tolerance of ``tests/test_torch_lm.py``: the two are the same
least-squares minimizer, their sums in another order.  Cases: (bl, bc, m2)
∈ {(2, 1, 5), (2, 2, 5), (7, 2, 3)}, nb ∈ {1, tile − 1, tile, 3·tile + 7}
(one partial, a ragged tile, a whole one, a stack of several), λ ∈
{0.37, 1e-12}, and a ragged tile past a group of partials (a level before
the finish); a tile of zero points (every column of its panel QR
degenerate) and a point with a zero block; the ``mesh=`` order emulated
over two shards; the vmapped batch against solo calls (one call of the
plain version for the batch); the gradient through the op's autograd
rule; the geometry gate ``lm_step_fits`` and the routes: a CPU tensor never
reaches the build, a tensor that reports a card reaches K3a, K3b's levels
and finish and K3c with its ordinal and stream, or the plain version by the
gate alone.

The ``cuda`` cases run on the card with ``python -m pytest --noconftest -m
cuda tests/test_torch_lm_step.py`` (JAX is imported inside the reference
helpers only): kernel against plain in fp32 (rtol 1e-4, atol
1e-5·max|·|) and fp64 (rtol 1e-10) at the ellipse's shapes and the edges,
two calls bitwise equal, a captured replay bitwise equal to the eager
call, the vmapped batch as one launch against solo calls, a step that
requires grad (K3 forward, its gradient against the CPU's), and a second
card.
"""
import numpy as np
import pytest
import torch

from qrkit_tpu_torch import functional, profiling
from qrkit_tpu_torch.ops import _build
from qrkit_tpu_torch.ops import lm_step as ls

TOL = dict(rtol=1e-10, atol=1e-10)
SHAPES = [(2, 1, 5), (2, 2, 5), (7, 2, 3)]
TILE = 4  # CPU tile: every nb below spans the edges of a few tiles


def _operands(rng, bl, bc, m2, nb, lead=()):
    return (rng.normal(size=(*lead, bl, bc, nb)), rng.normal(size=(*lead, bl, m2, nb)),
            rng.normal(size=(*lead, bl, nb)))


def _t(*arrays, dtype=torch.float64, device="cpu"):
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in arrays)


def _reference(left, right, res, lam):
    """qrkit_tpu's step, flattened as the wrapper returns it."""
    import jax.numpy as jnp

    from qrkit_tpu import functional as jf

    x1, x2 = jf.lm_damped_step_blockdiag(jnp.asarray(left), jnp.asarray(right), jnp.asarray(res),
                                         jnp.asarray(lam))
    return np.concatenate([np.asarray(x1).reshape(-1), np.asarray(x2)])


def _step(left, right, res, lam, **kw):
    l, r, v = _t(left, right, res)
    return ls.damped_step_lane_major(l, r, v, torch.tensor(lam, dtype=torch.float64), **kw)


def _close(got, want, **tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, **(tol or TOL))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("nb", [1, TILE - 1, TILE, 3 * TILE + 7])
@pytest.mark.parametrize("lam", [0.37, 1e-12])
def test_step_matches_reference(shape, nb, lam):
    bl, bc, m2 = shape
    rng = np.random.default_rng(100 * sum(shape) + nb)
    left, right, res = _operands(rng, bl, bc, m2, nb)
    out = _step(left, right, res, lam, tile=TILE)
    assert out.shape == (bc * nb + m2,)
    _close(out, _reference(left, right, res, lam))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_step_with_a_level_matches_reference(shape):
    """Past a group of partials (``default_group(m2)`` tiles, then a ragged
    one): one level of K3b before the finish."""
    bl, bc, m2 = shape
    nb = (ls.default_group(m2) + 1) * TILE + 1
    assert ls.reduce_levels(-(-nb // TILE), ls.default_group(m2)) == [2]
    rng = np.random.default_rng(sum(shape))
    left, right, res = _operands(rng, bl, bc, m2, nb)
    _close(_step(left, right, res, 0.37, tile=TILE), _reference(left, right, res, 0.37))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("nb", [40, 600])
def test_functional_step_matches_reference(shape, nb):
    """``functional.lm_damped_step_blockdiag(1)`` through the wrapper at its
    default tile (600 points: three tiles, a ragged one last)."""
    import jax.numpy as jnp

    from qrkit_tpu import functional as jf

    bl, bc, m2 = shape
    rng = np.random.default_rng(nb + bl)
    left, right, res = _operands(rng, bl, bc, m2, nb)
    x1, x2 = functional.lm_damped_step_blockdiag(*_t(left, right, res), 0.37)
    want = _reference(left, right, res, 0.37)
    _close(torch.cat([x1.reshape(-1), x2]), want)
    if bc == 1:
        flat = functional.lm_damped_step_blockdiag1(*_t(left[:, 0], right, res), 0.37)
        _close(flat, np.asarray(jf.lm_damped_step_blockdiag1(
            jnp.asarray(left[:, 0]), jnp.asarray(right), jnp.asarray(res), jnp.asarray(0.37))))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("lam", [0.37, 1e-6])
def test_zero_points(shape, lam):
    """A whole tile of zero points (its panel QR degenerate at every column:
    a zero partial) and a point whose block alone is zero.  (A zero block's
    R1 is √λ: at λ = 1e-12 its x1 is rounding noise over 1e-6 in both
    programs, some 1e-10, hence λ = 1e-6 here.)"""
    bl, bc, m2 = shape
    nb = 3 * TILE + 1
    rng = np.random.default_rng(11)
    left, right, res = _operands(rng, bl, bc, m2, nb)
    for a in (left, right, res):
        a[..., TILE : 2 * TILE] = 0.0
    left[..., 2 * TILE + 1] = 0.0
    out = _step(left, right, res, lam, tile=TILE)
    _close(out, _reference(left, right, res, lam))
    x1 = out[: bc * nb].reshape(bc, nb)
    assert torch.equal(x1[:, TILE : 2 * TILE], torch.zeros(bc, TILE, dtype=torch.float64))
    stack = ls._tile_partials_plain(ls._point_pass_plain(*_t(left[None], right[None], res[None]),
                                                         torch.tensor([lam]))[1], TILE)
    assert not stack[..., m2 : 2 * m2].any()  # the zero tile's partial


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_order_over_two_shards(shape):
    """The ``mesh=`` form's order on two shards of the points: each shard
    reduces its tiles to one partial, the two partials are stacked in rank
    order (the all-gather), the finish adds the tail; every shard's x2 and
    its x1 agree with the reference's step over all points."""
    bl, bc, m2 = shape
    nb = 2 * (2 * TILE + 3)
    rng = np.random.default_rng(5)
    left, right, res = _operands(rng, bl, bc, m2, nb)
    half = nb // 2
    shards = [tuple(a[..., s * half : (s + 1) * half] for a in (left, right, res)) for s in (0, 1)]
    partials = []
    for shard in shards:  # each rank's one partial
        _step(*shard, 0.37, tile=TILE, gather=lambda p: partials.append(p) or p)
    stacked = torch.cat(partials, dim=2)
    outs = [_step(*shard, 0.37, tile=TILE, gather=lambda p: stacked)
            for shard in shards]
    want = _reference(left, right, res, 0.37)
    x1_want = want[: bc * nb].reshape(bc, nb)
    for s, out in enumerate(outs):
        _close(out[bc * half :], want[bc * nb :])
        _close(out[: bc * half].reshape(bc, half), x1_want[:, s * half : (s + 1) * half])
    assert all(p.shape == (1, m2 + 1, m2) for p in partials)


def test_vmap_batch_matches_solo_calls(monkeypatch):
    """The batch fit's step under ``torch.func.vmap``: one call of the plain
    version for the whole batch (the op's vmap rule), per-problem λ and an
    unbatched one, each problem equal to its solo call."""
    rng = np.random.default_rng(3)
    bl, bc, m2, nb, B = 2, 1, 5, 2 * TILE + 3, 4
    left, right, res = _t(*_operands(rng, bl, bc, m2, nb, (B,)))
    lams = torch.tensor([0.37, 1e-3, 2.0, 1e-12], dtype=torch.float64)
    calls = []
    plain = ls._damped_step_plain
    monkeypatch.setattr(ls, "_damped_step_plain", lambda *a, **k: calls.append(a[0].shape) or plain(*a, **k))

    def one(l, r, v, lam):
        return ls.damped_step_lane_major(l, r, v, lam, tile=TILE)

    batch = torch.func.vmap(one)(left, right, res, lams)
    assert calls == [(B, bl, bc, nb)]
    shared = torch.func.vmap(one, in_dims=(0, 0, 0, None))(left, right, res, lams[0])
    for i in range(B):
        _close(batch[i], one(left[i], right[i], res[i], lams[i]).numpy(), rtol=1e-12, atol=0)
        _close(shared[i], one(left[i], right[i], res[i], lams[0]).numpy(), rtol=1e-12, atol=0)
    # the functional step, vmapped as lm.levenberg_marquardt_device_batch vmaps it
    calls.clear()
    flat = torch.func.vmap(functional.lm_damped_step_blockdiag1)(left[:, :, 0], right, res, lams)
    assert calls == [(B, bl, 1, nb)]
    for i in range(B):
        _close(flat[i], functional.lm_damped_step_blockdiag1(
            left[i, :, 0], right[i], res[i], lams[i]).numpy(), rtol=1e-12, atol=0)


def test_grad_runs_the_plain_version():
    """Operands that require grad go through the op's autograd rule: its
    backward is the plain version's vector-Jacobian product (the kernels
    compute no derivative), here against finite differences."""
    rng = np.random.default_rng(8)
    args = [t.requires_grad_() for t in _t(*_operands(rng, 2, 1, 3, 5))]
    lam = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda l, r, v, s: ls.damped_step_lane_major(l, r, v, s, tile=2),
        (*args, lam))


def test_lm_step_fits():
    assert ls.lm_step_fits(2, 1, 5, 8) and ls.lm_step_fits(2, 2, 5, 8)
    assert ls.lm_step_fits(7, 2, 5, 8) and ls.lm_step_fits(7, 2, 5, 4)
    assert ls.lm_step_fits(2, 1, 16, 4) and not ls.lm_step_fits(2, 1, 16, 8)  # K3b's registers
    assert not ls.lm_step_fits(2, 1, 17, 4)  # m2 past 16
    assert not ls.lm_step_fits(10, 3, 8, 8) and ls.lm_step_fits(10, 3, 8, 4)  # K3a's registers
    assert ls.default_group(5) == 408 and ls.reduce_levels(391, 408) == []
    assert ls.reduce_levels(1954, 408) == [5]  # 500k points in tiles of 256


class _OnCuda1(torch.Tensor):
    """A CPU tensor that reports cuda:1, so the wrapper takes its kernel path."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.fixture
def launch_recorder(monkeypatch):
    """The K3 libraries swapped for a recorder of (name, args); the stream
    of cuda:N reads as 1000 + N.  The launch counters are restored after."""
    calls = []

    class Library:
        def __getattr__(self, name):
            def record(*args):
                calls.append((name, args))
                return 0

            record.__name__ = name
            return record

    monkeypatch.setattr(_build, "load_lm_step", lambda bl, bc, m2: Library())
    monkeypatch.setattr(_build, "current_stream", lambda device: 1000 + device)
    for fn in profiling._KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    _build.lm_step_launcher.cache_clear()
    yield calls
    _build.lm_step_launcher.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernel_path_reaches_its_launchers(launch_recorder, dtype):
    """Operands on cuda:1 reach K3a, one level of K3b, its finish and K3c
    with ordinal 1, cuda:1's stream and the planned geometry; one launch
    counted."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    rng = np.random.default_rng(4)
    bl, bc, m2, nb, P = 2, 1, 5, 32 * 409 + 7, 3
    group = ls.default_group(m2)  # 408
    ops = [t.as_subclass(_OnCuda1) for t in _t(*_operands(rng, bl, bc, m2, nb, (P,)), dtype=dtype)]
    lam = torch.full((P,), 0.1, dtype=dtype).as_subclass(_OnCuda1)
    out = ls._run(*ops, lam, 32)
    assert out.shape == (P, bc * nb + m2)
    names = [name for name, _ in launch_recorder]
    assert names == [f"qrk_lm_{k}_{sfx}" for k in ("local", "reduce", "reduce", "backsub")]
    assert all(args[0] == 1 and args[-1] == 1001 for _, args in launch_recorder)
    local, lv1, fin, back = (args for _, args in launch_recorder)
    assert local[7:-1] == (nb, P, 32)  # 410 tiles
    assert lv1[2] == 410 * m2 and lv1[5:-1] == (0, group, P, 0)  # 410 partials → 2
    stride = bc * nb + m2
    assert fin[2] == 2 * m2 and fin[5:-1] == (stride, group, P, 1)
    assert fin[4] == back[2] and back[4:-1] == (nb, P, stride)
    assert profiling.launch_counts()["lm_step"] == 1


def test_routes(launch_recorder, monkeypatch):
    """A CPU tensor never reaches the build; on the card a step shape past
    ``lm_step_fits`` takes the plain version in ``_run``, by the gate alone
    (``functional`` makes the one call), the kernel path refuses what it
    does not take, and the mesh form refuses operands that require grad."""
    monkeypatch.setattr(_build, "load_lm_step", lambda *a: pytest.fail("built on the CPU"))
    rng = np.random.default_rng(6)
    left, right, res = _t(*_operands(rng, 2, 1, 5, 9))
    functional.lm_damped_step_blockdiag(left, right, res, 0.37)
    assert profiling.launch_counts()["lm_step"] == 0
    big = [t.as_subclass(_OnCuda1) for t in _t(*_operands(rng, 12, 4, 8, 9))]
    lam = torch.tensor(0.37, dtype=torch.float64).as_subclass(_OnCuda1)
    plain = []
    monkeypatch.setattr(ls, "_damped_step_plain",
                        lambda l, *a, **k: plain.append(l.shape) or l.new_zeros((1, 4 * 9 + 8)))
    x1, x2 = functional._damped_step(*big, lam)
    assert plain == [(1, 12, 4, 9)] and x1.shape == (4, 9) and x2.shape == (8,)
    assert not launch_recorder
    ops = [t.as_subclass(_OnCuda1) for t in _t(*_operands(rng, 2, 1, 5, 9, (1,)))]
    lam1 = lam.reshape(1)
    with pytest.raises(ValueError, match="tile"):
        ls._run(*ops, lam1, 48)
    with pytest.raises(ValueError, match="backward"):
        ls.damped_step_lane_major(*(t[0].requires_grad_() for t in ops), lam, gather=lambda p: p)
    assert not launch_recorder


def test_wrapper_refuses_bad_operands():
    rng = np.random.default_rng(9)
    left, right, res = _t(*_operands(rng, 2, 1, 5, 9))
    lam = torch.tensor(0.1, dtype=torch.float64)
    with pytest.raises(TypeError):
        ls.damped_step_lane_major(left.float(), right, res, lam)
    with pytest.raises(ValueError, match="right"):
        ls.damped_step_lane_major(left, right[:, :, :8], res, lam)
    with pytest.raises(ValueError, match="res"):
        ls.damped_step_lane_major(left, right, res[:1], lam)
    with pytest.raises(ValueError, match="tile"):
        ls.damped_step_lane_major(left, right, res, lam, tile=2)  # 2·2 < 5 lanes


# --- on the card --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tol(dtype):
    return (1e-10, 1e-12) if dtype == torch.float64 else (1e-4, 1e-5)


def _assert_kernel_close(got, want, dtype):
    rtol, atol_rel = _tol(dtype)
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol_rel * want.abs().max().item())


CUDA_CASES = [  # (bl, bc, m2, nb, problems); 500k and 180k points run a level of K3b
    (2, 1, 5, 100_000, 1), (2, 1, 5, 500_000, 1), (2, 2, 5, 100_000, 1), (7, 2, 5, 100_000, 1),
    (7, 2, 3, 1, 1), (2, 1, 5, 255, 3), (2, 1, 5, 20_000, 2), (2, 2, 5, 257, 1),
    (7, 2, 3, 180_000, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_kernel_matches_plain(cuda_device, case, dtype):
    bl, bc, m2, nb, P = case
    rng = np.random.default_rng(nb + P)
    ops = _t(*_operands(rng, bl, bc, m2, nb, (P,)), dtype=dtype, device=cuda_device)
    lam = torch.as_tensor(rng.uniform(1e-3, 1.0, size=P), dtype=dtype, device=cuda_device)
    before = ls.damped_step_lane_major.launches
    out = ls.damped_step_lane_major(*ops, lam)
    again = ls.damped_step_lane_major(*ops, lam)
    torch.cuda.synchronize()
    assert ls.damped_step_lane_major.launches == before + 2
    assert torch.equal(out, again)
    want = ls._damped_step_plain(*(t.cpu() for t in ops), lam.cpu(), ls.TILE)
    _assert_kernel_close(out, want, dtype)


@pytest.mark.cuda
def test_cuda_grad_launches_k3(cuda_device):
    """A step whose operands require grad launches K3 for its forward; its
    gradient (the plain version's vector-Jacobian product, on the card)
    matches the CPU's at fp64 rtol 1e-10."""
    rng = np.random.default_rng(12)
    host = _t(*_operands(rng, 2, 1, 5, 3000), np.float64(0.3))
    g = torch.as_tensor(rng.normal(size=3000 + 5), dtype=torch.float64)

    def grads(device):
        ops = [t.to(device).requires_grad_() for t in host]
        out = ls.damped_step_lane_major(*ops)
        return out, torch.autograd.grad(out, ops, g.to(device))

    before = ls.damped_step_lane_major.launches
    out, got = grads(cuda_device)
    torch.cuda.synchronize()
    assert ls.damped_step_lane_major.launches == before + 1
    want_out, want = grads("cpu")
    _assert_kernel_close(out.detach(), want_out.detach(), torch.float64)
    for a, b in zip(got, want):
        _assert_kernel_close(a, b, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_vmap_and_replay(cuda_device, dtype):
    """16 problems of 10,000 points under vmap: one launch, each problem
    within the gate of its solo call; a captured replay bitwise equal to
    the eager call."""
    rng = np.random.default_rng(2)
    B, nb = 16, 10_000
    ops = _t(*_operands(rng, 2, 1, 5, nb, (B,)), dtype=dtype, device=cuda_device)
    lam = torch.as_tensor(rng.uniform(1e-3, 1.0, size=B), dtype=dtype, device=cuda_device)
    before = ls.damped_step_lane_major.launches
    batch = torch.func.vmap(ls.damped_step_lane_major)(*ops, lam)
    torch.cuda.synchronize()
    assert ls.damped_step_lane_major.launches == before + 1
    for i in range(B):
        solo = ls.damped_step_lane_major(*(t[i] for t in ops), lam[i])
        _assert_kernel_close(batch[i], solo, dtype)
    eager = ls.damped_step_lane_major(*ops, lam)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.graph(graph, stream=stream):
        captured = ls.damped_step_lane_major(*ops, lam)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_cuda_kernels_on_a_second_card(cuda_device):
    """With cuda:0 current, K3 runs on a cuda:1 operand's card, gives the
    bits it gives on cuda:0, and leaves cuda:0 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(1)
    ops = _t(*_operands(rng, 2, 1, 5, 1000), np.float64(0.3))
    torch.cuda.set_device(0)
    want = ls.damped_step_lane_major(*(t.to("cuda:0") for t in ops))
    got = ls.damped_step_lane_major(*(t.to("cuda:1") for t in ops))
    assert torch.cuda.current_device() == 0 and got.device == torch.device("cuda", 1)
    assert torch.equal(got.cpu(), want.cpu())
