"""The lane-major damped LM step as kernel K3 (``ops.lm_step``).

On the CPU the wrapper ``damped_step_lane_major`` runs its plain version,
the kernel's schedule sum by sum: the per-point pass, each thread's carry
``[R | Qᵀy]`` absorbing its points of every tile of its task's run, the
warp and CTA merges, the last task's finish over the task partials in
index order with the √λ·I tail, and the per-point back-substitution.
Here, at small tiles so that every stage runs (runs of several tiles
once the points make more than ``CTAS`` tiles), it is held against
``qrkit_tpu.functional.lm_damped_step_blockdiag`` (one QR over every lane,
jitted on the CPU) at fp64 rtol 1e-10 (atol 1e-10), the tolerance of
``tests/test_torch_lm.py``: the two are the same least-squares minimizer,
their sums in another order.  Cases: (bl, bc, m2) ∈ {(2, 1, 5), (2, 2, 5),
(7, 2, 3)}, nb ∈ {1, tile − 1, tile, 3·tile + 7} (one partial, a ragged
tile, a whole one, several), λ ∈ {0.37, 1e-12}, runs of several tiles with
a ragged last one, other grid sizes (a CTA with two tasks); a tile of zero
points (a zero partial) and a point with a zero block; the ``mesh=`` order
emulated over two shards; the vmapped batch against solo calls (one call
of the plain version for the batch); the gradient through the op's
autograd rule (its vector-Jacobian product against finite differences,
and against ``jax.grad`` of the reference's at λ 0.37 and 1e-12);
the geometry gate ``lm_step_fits``, the schedule and the
routes: a CPU tensor never reaches the build, a tensor that reports a card
reaches the one launch with its ordinal, stream and geometry (the mesh
form: its two), or the plain version by the gate alone; the mesh form's
grad through ``functional`` launches K3 forward and differentiates.

The ``cuda`` cases run on the card with ``python -m pytest --noconftest -m
cuda tests/test_torch_lm_step.py`` (JAX is imported inside the reference
helpers only): kernel against plain in fp32 (rtol 1e-4, atol
1e-5·max|·|) and fp64 (rtol 1e-10) at the ellipse's shapes and the edges,
two calls bitwise equal, three replays of a captured step bitwise equal
to the eager call (the counters clean after each call), two steps on two
streams at once each equal to its solo call, the vmapped batch as one
launch (one cooperative K3 node and one memset node in its captured
graph) against solo calls, a step that requires grad (one launch forward,
its gradient against the CPU's), and a second card.
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
    """Past ``CTAS`` tiles: every task a run of three or four tiles (a
    thread's carry over several points), the last tile ragged; the same
    step on a grid of 5 CTAs (runs of some 80 tiles) and three problems on
    2 CTAs (one run a problem, two tasks on a CTA)."""
    bl, bc, m2 = shape
    nb = (3 * ls.CTAS + 5) * TILE + 1
    assert ls.schedule(nb, 1, TILE) == (3 * ls.CTAS + 6, ls.CTAS, ls.CTAS)
    rng = np.random.default_rng(sum(shape))
    left, right, res = _operands(rng, bl, bc, m2, nb)
    want = _reference(left, right, res, 0.37)
    _close(_step(left, right, res, 0.37, tile=TILE), want)
    lam = torch.tensor([0.37], dtype=torch.float64)
    _close(ls._damped_step_plain(*_t(left[None], right[None], res[None]), lam, TILE, ctas=5)[0], want)
    many = _operands(rng, bl, bc, m2, 2 * TILE + 1, (3,))
    assert ls.schedule(2 * TILE + 1, 3, TILE, 2) == (3, 1, 2)
    out = ls._damped_step_plain(*_t(*many), torch.full((3,), 0.37, dtype=torch.float64), TILE, ctas=2)
    for i in range(3):
        _close(out[i], _reference(*(a[i] for a in many), 0.37))


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
    comp = ls._point_pass_plain(*_t(left[None], right[None], res[None]), torch.tensor([lam]))[1]
    tiles, segs, _ = ls.schedule(nb, 1, TILE)
    carries = ls._task_carries_plain(comp, TILE, segs, tiles)
    assert segs == tiles == 4 and not carries[:, 1].any()  # the zero tile's partial


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
    backward is the vector-Jacobian product of ``_damped_step_dense`` (the
    kernel computes no derivative), here against finite differences."""
    rng = np.random.default_rng(8)
    args = [t.requires_grad_() for t in _t(*_operands(rng, 2, 1, 3, 5))]
    lam = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda l, r, v, s: ls.damped_step_lane_major(l, r, v, s, tile=2),
        (*args, lam))


@pytest.mark.parametrize("kind", ["normal", "ellipse"])
def test_grad_in_fp32(kind):
    """fp32 operands that require grad: over 3,000 points (a thread's carry
    of two rows, fewer than m2, so columns of rounding noise) the gradients
    are finite and within the fp32 gate (rtol 1e-4, atol 1e-5·max|·|) of
    the fp64 operands' (the backward runs in fp64 on one QR of the bottom
    panel; through the tiled plain version's noise columns fp32
    overflowed to NaN)."""
    from qrkit_tpu_torch.examples import ellipse

    rng = np.random.default_rng(12)
    nb = 3000
    if kind == "normal":
        host = _t(*_operands(rng, 2, 1, 5, nb))
    else:
        f = ellipse.EllipseFitting(ellipse.ellipse_points(ellipse.Ellipse(7.5, 2.0, 17.0, 23.0, 0.23), nb),
                                   dtype=torch.float64, device="cpu")
        params = f.initial_params()
        left, right = ellipse._jacobian_soa(params, f.pts)
        host = (left[:, None, :].contiguous(), right, ellipse._residuals_soa(params, f.pts))
    g = torch.as_tensor(rng.normal(size=nb + 5))
    grads = {}
    for dt in (torch.float32, torch.float64):
        ops = [t.to(dt).requires_grad_() for t in host] + [torch.tensor(1e-3, dtype=dt, requires_grad=True)]
        grads[dt] = torch.autograd.grad(ls.damped_step_lane_major(*ops), ops, g.to(dt))
    for got, want in zip(grads[torch.float32], grads[torch.float64]):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        _close(got.double(), want.numpy(), rtol=1e-4, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("lam", [0.37, 1e-12])
def test_grad_matches_reference(shape, lam):
    """``mesh=None``: the gradients of a loss of the step (through
    ``functional.lm_damped_step_blockdiag``, and ``…1`` where bc = 1) with
    respect to left, right, res and λ (``_damped_step_dense``'s route)
    against ``jax.grad`` of qrkit_tpu's, λ = 1e-12 too;
    fp64 rtol 1e-9 (as the mesh step's).  λ's gradient, −uᵀδ with u =
    A⁻¹(∂loss/∂δ), is as ill-conditioned as A = JᵀJ + λI: where J has
    fewer rows than columns ((2, 2, 5): 2·nb rows, 2·nb + 5 columns) κ(A)
    is σ_max²/λ, some 7e13 at λ = 1e-12, and every fp64 evaluation, the
    reference's too, is off the exact gradient by up to eps·κ(A); there it
    is held at rtol max(1e-9, eps·κ(A))."""
    import jax
    import jax.numpy as jnp

    from qrkit_tpu import functional as jf

    bl, bc, m2 = shape
    nb = 3 * TILE + 7
    rng = np.random.default_rng(31 + sum(shape))
    left, right, res = _operands(rng, bl, bc, m2, nb)
    w = rng.normal(size=bc * nb + m2)
    forms = [(jf.lm_damped_step_blockdiag, functional.lm_damped_step_blockdiag, left)]
    if bc == 1:
        forms.append((jf.lm_damped_step_blockdiag1, functional.lm_damped_step_blockdiag1, left[:, 0]))
    for ref, port, lf in forms:
        def flat(out, cat):
            return out if not isinstance(out, tuple) else cat([out[0].reshape(-1), out[1]])

        def jloss(l, r, v, s):
            x = flat(ref(l, r, v, s), jnp.concatenate)
            return jnp.sum(jnp.asarray(w) * x) + 0.5 * jnp.sum(x * x)

        want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (lf, right, res, lam)))
        ops = [t.requires_grad_() for t in _t(lf, right, res, lam)]
        x = flat(port(*ops), torch.cat)
        got = torch.autograd.grad((torch.as_tensor(w) * x).sum() + 0.5 * (x * x).sum(), ops)
        sv = np.linalg.svd(_dense_jacobian(left, right), compute_uv=False)
        kappa = (sv[0] ** 2 + lam) / ((sv[-1] ** 2 if sv.size == bc * nb + m2 else 0.0) + lam)
        for g, want_g, name in zip(got, want, ("left", "right", "res", "lam")):
            want_g = np.asarray(want_g)
            rtol = max(1e-9, np.finfo(np.float64).eps * kappa) if name == "lam" else 1e-9
            np.testing.assert_allclose(g.numpy(), want_g, rtol=rtol, atol=1e-9 * np.abs(want_g).max(),
                                       err_msg=name)


def _dense_jacobian(left, right):
    """J = [blkdiag(left_i) | right] ``[bl·nb, bc·nb + m2]`` (row i·nb + p:
    point p's row i; x1's column c·nb + p, then x2's)."""
    bl, bc, nb = left.shape
    m2 = right.shape[1]
    J = np.zeros((bl * nb, bc * nb + m2))
    p = np.arange(nb)
    for i in range(bl):
        for c in range(bc):
            J[i * nb + p, c * nb + p] = left[i, c]
        J[i * nb:(i + 1) * nb, bc * nb:] = right[i].T
    return J


def test_lm_step_fits():
    assert ls.lm_step_fits(2, 1, 5, 8) and ls.lm_step_fits(2, 2, 5, 8)
    assert ls.lm_step_fits(7, 2, 5, 8) and ls.lm_step_fits(7, 2, 5, 4)
    assert ls.lm_step_fits(2, 1, 12, 4) and not ls.lm_step_fits(2, 1, 12, 8)  # the carry's registers
    assert not ls.lm_step_fits(2, 1, 17, 4)  # m2 past 16
    assert not ls.lm_step_fits(10, 3, 8, 8) and ls.lm_step_fits(8, 3, 6, 4)  # a point's registers
    assert not ls.lm_step_fits(8, 3, 6, 8)
    # the ellipse at 100k and 500k points, the batch fit's 16 problems of 10,000
    assert ls.schedule(100_000, 1) == (391, 132, 132) and ls.schedule(500_000, 1) == (1954, 132, 132)
    assert ls.schedule(10_000, 16) == (40, 8, 128) and ls.schedule(0, 1) == (1, 1, 1)


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

    monkeypatch.setattr(_build, "load_lm_step", lambda bl, bc, m2, extra=(): Library())
    monkeypatch.setattr(_build, "current_stream", lambda device: 1000 + device)
    for fn in profiling._KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    _build.lm_step_launcher.cache_clear()
    yield calls
    _build.lm_step_launcher.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernel_path_reaches_its_launchers(launch_recorder, dtype):
    """Operands on cuda:1 reach K3's one launch (the full mode) with ordinal
    1, cuda:1's stream, the operands, a null gathered stack, the output's
    stride, the counters, the points, problems, tile and the mode (C is
    the source's); the mesh form reaches its two (the rank's partial, then
    the finish from the gathered stack of its ranks' partials), and
    ``partial_step`` the first alone; one step counted each."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    rng = np.random.default_rng(4)
    bl, bc, m2, nb, P = 2, 1, 5, 32 * 409 + 7, 3
    ops = [t.as_subclass(_OnCuda1) for t in _t(*_operands(rng, bl, bc, m2, nb, (P,)), dtype=dtype)]
    lam = torch.full((P,), 0.1, dtype=dtype).as_subclass(_OnCuda1)
    out = ls._run(*ops, lam, 32)
    assert out.shape == (P, bc * nb + m2)
    assert ls.schedule(nb, P, 32) == (410, 44, 132)  # 44 runs of 9 or 10 tiles a problem
    ((name, args),) = launch_recorder
    assert name == f"qrk_lm_step_{sfx}" and args[0] == 1 and args[-1] == 1001
    assert args[1:5] == tuple(t.data_ptr() for t in (*ops, lam))
    stride = bc * nb + m2
    assert args[7:9] == (None, 0) and args[9] == out.data_ptr() and args[10] == stride
    assert args[12:-1] == (nb, P, 32, 0)  # …, the full mode
    assert profiling.launch_counts()["lm_step"] == 1
    launch_recorder.clear()
    one = [t[0] for t in ops]
    gathered = []

    def gather(part):  # two ranks' partials
        assert part.shape == (1, m2 + 1, m2)
        gathered.append(torch.cat([part, part], dim=2))
        return gathered[-1]

    out = ls._run(*(t[None] for t in one), lam[:1], 256, gather)
    (n1, a1), (n2, a2) = launch_recorder
    assert n1 == n2 == f"qrk_lm_step_{sfx}"
    assert a1[7:9] == (None, 0) and a1[10] == 0 and a1[12:-1] == (nb, 1, 256, 1)
    assert a2[7:9] == (gathered[0].data_ptr(), 2) and a2[9] == out.data_ptr()
    assert a2[10] == stride and a2[12:-1] == (nb, 1, 256, 2)
    assert a1[1:7] == a2[1:7] and a1[11] == a2[11]  # one factor buffer, stack and counters
    assert profiling.launch_counts()["lm_step"] == 2
    launch_recorder.clear()
    part = ls.partial_step(*ops, lam, tile=64)
    ((name, args),) = launch_recorder
    assert part.shape == (P, m2 + 1, m2) and args[9] == part.data_ptr() and args[10] == 0
    assert args[12:-1] == (nb, P, 64, 1)  # the first mode alone
    assert profiling.launch_counts()["lm_step"] == 3


def test_routes(launch_recorder, monkeypatch):
    """A CPU tensor never reaches the build; on the card a step shape past
    ``lm_step_fits`` takes the plain version in ``_run``, by the gate alone
    (``functional`` makes the one call), the kernel path refuses what it
    does not take; the mesh form's grad step through ``functional`` runs
    K3 forward (its two launches) and its backward, while the wrapper's own
    mesh form refuses grad on either device."""
    recorder = _build.load_lm_step
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
    assert not launch_recorder
    cpu = (*_t(*_operands(rng, 2, 1, 5, 9)), torch.tensor(0.37, dtype=torch.float64))
    for grad_ops in ((*(t[0].clone() for t in ops), lam.clone()), cpu):
        with pytest.raises(ValueError, match="backward"):
            ls.damped_step_lane_major(*(t.requires_grad_() for t in grad_ops), gather=lambda p: p)
    # one rank's collectives as identities: the mesh step under grad on the card
    from qrkit_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "mesh_rank", lambda mesh, axis="dp": (0, 1))
    monkeypatch.setattr(pmesh, "all_gather_leading", lambda x, mesh, axis="dp", sizes=None: x.clone())
    monkeypatch.setattr(pmesh, "all_reduce_sum", lambda x, mesh, axis="dp": x.clone())
    monkeypatch.setattr(ls, "_damped_step_plain", _PLAIN)
    monkeypatch.setattr(_build, "load_lm_step", recorder)
    grad_ops = [t[0].clone().requires_grad_() for t in ops]
    lam_g = torch.tensor(0.37, dtype=torch.float64).as_subclass(_OnCuda1).requires_grad_()
    x1, x2 = functional._damped_step(*grad_ops, lam_g, mesh=object())
    assert [a[-2] for _, a in launch_recorder] == [1, 2]  # the rank's partial, then the finish
    torch.cat([x1.reshape(-1), x2]).sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape for t in (*grad_ops, lam_g))


_PLAIN = ls._damped_step_plain


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
        ls.damped_step_lane_major(left, right, res, lam, tile=0)  # a tile holds no point


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


CUDA_CASES = [  # (bl, bc, m2, nb, problems); past 132·kRegPoints tiles the factor rows go to memory
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
    """A step whose operands require grad launches K3 once for its forward;
    its gradient (``_damped_step_dense``'s vector-Jacobian product on the
    card) matches the CPU's at fp64 rtol 1e-10."""
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
    within the gate of its solo call; the captured call holds one K3 node
    (cooperative, on the schedule's grid) and one memset node; three
    replays bitwise equal to the eager call."""
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
    nodes = profiling.graph_nodes(lambda: torch.func.vmap(ls.damped_step_lane_major)(*ops, lam))
    k3 = [n for n in nodes if n["type"] == "kernel" and "lm_step_kernel" in n["name"]]
    assert [(n["grid"][0], n["block"][0], n["cooperative"]) for n in k3] == [(ls.schedule(nb, B)[2], ls.TILE, True)]
    assert sum(n["type"] == "memset" for n in nodes) == 1
    eager = ls.damped_step_lane_major(*ops, lam)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.graph(graph, stream=stream):
        captured = ls.damped_step_lane_major(*ops, lam)
    for _ in range(3):  # the counters are zeroed by each replay's memset node
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_cuda_two_streams_at_once(cuda_device):
    """Two steps enqueued on two streams at once (each call's own counters)
    each equal its solo call, bitwise."""
    rng = np.random.default_rng(5)
    a = _t(*_operands(rng, 2, 1, 5, 200_000), np.float32(0.01), dtype=torch.float32, device=cuda_device)
    b = _t(*_operands(rng, 2, 1, 5, 150_000), np.float32(0.2), dtype=torch.float32, device=cuda_device)
    solo = [ls.damped_step_lane_major(*ops) for ops in (a, b)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for ops, st in zip((a, b), streams):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(ls.damped_step_lane_major(*ops))
    torch.cuda.synchronize()
    for got, want in zip(outs, solo):
        assert torch.equal(got, want)


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
