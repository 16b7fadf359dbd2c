"""The L-BFGS compact direction's ring passes (``ops/lbfgs_ring.py``).

On the CPU: the plain products and combination against float64, the
plain path kept for CPU tensors and for an fp32 ring (no kernel is
called and the launch counter stays 0), the rule that picks the
kernels, the kernel wrappers' refusals (checked before any build), and
the products kernel's launch plan.

The ``cuda``-marked tests run on the card only (each skips without
one; it is decided inside the fixture, never at import): the two
kernels of ``csrc/lbfgs_ring.cu`` against their plain versions at
the 512x512 ring (n = 786,432, m = 100), a ragged n (5,883 = 3 x 37 x
53, odd, so the unaligned loads), m = 5, and m = 150 (a grid of 2 x 2
block tiles), over an empty ring, one pair, a partly filled ring and a
full one wrapped past ``hist_pos``; the direction the composition of
the two, bit for bit; the batched direction at S = 4 bit-equal to each
style's single one; two runs, and a graph replay against the eager
call, bit-equal; and 2 launches a style an iteration counted by the
kernels through a graphed run. Tolerances: each of the four products
within 1e-5 of the sum of the absolute products behind it (float64
exact; both sides take exact products of the same bf16 values and sum
them in fp32, about 1e-7 relative). The direction's coefficients from
the kernel's products within ``|c_kernel - c_plain| / |c_plain| <=
1e-5`` of those from the plain products (the test rings are well
conditioned): 1e-5 lies under the 2.3e-5 to 5e-5 that the benchmark's
``dir`` check reads for the port against a float64 reference on real
rings (its lower readings), so a kernel that met the test would not
move that check. The coefficients are compared before their rounding
to bf16: a difference of 1e-7 can move a coefficient across a bf16
rounding boundary, a step of 2^-8 of it, which says nothing of the
kernels. The combination, given the same coefficients, within 1e-6 of
the plain one (both sum m exact products a column in fp32). The file
imports no JAX; on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_lbfgs_ring.py
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu_torch.engine import optimizers
from style_transfer_visualizer_tpu_torch.engine.optimizers import (
    LbfgsState,
    _compact_direction,
    _style,
)
from style_transfer_visualizer_tpu_torch.ops import lbfgs_ring

DIR_TOL = 1e-5
PRODUCT_TOL = 1e-5
COMBINE_TOL = 1e-6


def _ring_state(
    m: int, n: int, length: int, pos: int, *, device="cpu", seed=0,
    dtype=torch.bfloat16,
) -> tuple[torch.Tensor, LbfgsState]:
    """A gradient and a state whose ring holds ``length`` pairs ending
    at slot ``pos - 1`` (zeros elsewhere): ``y = s + 0.1 noise``, so
    every pair has positive curvature and R is well conditioned."""
    gen = torch.Generator(device=device).manual_seed(seed)
    state = optimizers.lbfgs_init(n, m, device, dtype)
    for k in range(length):
        slot = (pos - length + k) % m
        s = torch.randn(n, generator=gen, device=device)
        y = s + 0.1 * torch.randn(n, generator=gen, device=device)
        state.s_hist[slot] = s.to(dtype)
        state.y_hist[slot] = y.to(dtype)
    state.hist_len.fill_(length)
    state.hist_pos.fill_(pos % m)
    state.h_diag.fill_(0.5)
    grad = torch.randn(n, generator=gen, device=device)
    return grad, state


# (length, pos) of the ring as a fraction of m: empty, one pair, partly
# filled, full and wrapped past hist_pos.
RING_STATES = {
    "empty": lambda m: (0, 0),
    "one_pair": lambda m: (1, 1),
    "partly": lambda m: (m // 2 + 1, m // 2 + 1),
    "wrapped": lambda m: (m, 37 % m),
}


def _products64(s_hist, y_hist, grad):
    s = s_hist.double()
    y = y_hist.double()
    g = grad.to(s_hist.dtype).double()
    exact = (s @ y.T, y @ y.T, s @ g, y @ g)
    sa, ya, ga = s.abs(), y.abs(), g.abs()
    scale = (sa @ ya.T, ya @ ya.T, sa @ ga, ya @ ga)
    return exact, scale


def _assert_products(got, s_hist, y_hist, grad) -> None:
    exact, scale = _products64(s_hist, y_hist, grad)
    for name, g, e, sc in zip("sy yy p q".split(), got, exact, scale,
                              strict=True):
        err = (g.double() - e).abs()
        assert bool((err <= PRODUCT_TOL * sc + 1e-30).all()), (
            name, float((err / (sc + 1e-30)).max()),
        )


# --- on the CPU ------------------------------------------------------------


@pytest.mark.parametrize(("m", "n"), [(5, 5883), (7, 64), (3, 1)])
def test_products_plain_matches_float64(m, n) -> None:
    grad, state = _ring_state(m, n, m, 2)
    _assert_products(
        lbfgs_ring.products_plain(state.s_hist, state.y_hist, grad),
        state.s_hist, state.y_hist, grad,
    )


def test_plain_blocks_equal_one_block(monkeypatch) -> None:
    m, n = 6, 1000
    grad, state = _ring_state(m, n, m, 4)
    cs, cy = torch.randn(m), torch.randn(m)
    gamma = torch.tensor(0.7)
    whole = lbfgs_ring.products_plain(state.s_hist, state.y_hist, grad)
    d_whole = lbfgs_ring.combine_plain(
        state.s_hist, state.y_hist, grad, cs, cy, gamma,
    )
    monkeypatch.setattr(lbfgs_ring, "UPCAST_COLUMNS", 96)
    blocked = lbfgs_ring.products_plain(state.s_hist, state.y_hist, grad)
    d_blocked = lbfgs_ring.combine_plain(
        state.s_hist, state.y_hist, grad, cs, cy, gamma,
    )
    _assert_products(blocked, state.s_hist, state.y_hist, grad)
    for a, b in zip(whole, blocked, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(d_whole, d_blocked, rtol=1e-6, atol=1e-6)


def test_combine_plain_matches_float64() -> None:
    m, n = 5, 777
    grad, state = _ring_state(m, n, 3, 4)
    cs, cy = torch.randn(m), torch.randn(m)
    gamma = torch.tensor(0.3)
    got = lbfgs_ring.combine_plain(
        state.s_hist, state.y_hist, grad, cs, cy, gamma,
    )
    c_s = cs.to(torch.bfloat16).double()
    c_y = cy.to(torch.bfloat16).double()
    want = -(0.3 * grad.double() + c_s @ state.s_hist.double()
             - 0.3 * (c_y @ state.y_hist.double()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_compact_direction_keeps_the_plain_path_on_cpu(
    dtype, monkeypatch,
) -> None:
    def refuse(*_a, **_k):
        msg = "a kernel was called on the CPU"
        raise AssertionError(msg)

    monkeypatch.setattr(lbfgs_ring, "products_kernel", refuse)
    monkeypatch.setattr(lbfgs_ring, "combine_kernel", refuse)
    lbfgs_ring.launches.reset()
    grad, state = _ring_state(5, 300, 4, 1, dtype=dtype)
    d = _compact_direction(grad, state)
    assert d.shape == grad.shape
    assert bool(torch.isfinite(d).all())
    # A descent direction on a ring of positive curvature.
    assert float(torch.dot(grad, d)) < 0
    assert lbfgs_ring.launches.count == 0
    assert lbfgs_ring.launches.launched() == 0


def test_on_kernels_takes_a_cuda_gradient_and_a_bf16_ring() -> None:
    def t(device, dtype=torch.float32):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype)

    assert lbfgs_ring.on_kernels(t("cuda:0"), t("cuda:0", torch.bfloat16))
    assert not lbfgs_ring.on_kernels(t("cuda:0"), t("cuda:0"))
    assert not lbfgs_ring.on_kernels(t("cpu"), t("cpu", torch.bfloat16))
    assert not lbfgs_ring.on_kernels(t("cpu"), t("cpu"))


def _bad_inputs(case: str):
    m, n = 4, 40
    s = torch.zeros((m, n), dtype=torch.bfloat16)
    y = torch.zeros((m, n), dtype=torch.bfloat16)
    g = torch.zeros(n)
    if case == "non_contiguous":
        s = torch.zeros((m, 2 * n), dtype=torch.bfloat16)[:, ::2]
    elif case == "ring_shapes":
        y = torch.zeros((m + 1, n), dtype=torch.bfloat16)
    elif case == "grad_shape":
        g = torch.zeros(n + 1)
    elif case == "fp32_ring":
        s, y = s.float(), y.float()
    elif case == "grad_dtype":
        g = g.double()
    return s, y, g


_REFUSALS = {
    "non_contiguous": "contiguous ring",
    "ring_shapes": "not an \\(m, n\\) ring",
    "grad_shape": "float32 gradient of shape",
    "fp32_ring": "bfloat16 ring",
    "grad_dtype": "float32 gradient",
    "cpu": "CUDA tensors",
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_kernel_wrappers_refuse(case) -> None:
    lbfgs_ring.launches.reset()
    s, y, g = _bad_inputs(case)
    m = s.shape[0]
    with pytest.raises(ValueError, match=_REFUSALS[case]):
        lbfgs_ring.products_kernel(s, y, g)
    with pytest.raises(ValueError, match=_REFUSALS[case]):
        lbfgs_ring.combine_kernel(
            s, y, g, torch.zeros(m), torch.zeros(m), torch.tensor(1.0),
        )
    assert lbfgs_ring.launches.count == 0


def test_combine_kernel_refuses_coefficients() -> None:
    s = torch.zeros((4, 40), dtype=torch.bfloat16)
    g = torch.zeros(40)
    with pytest.raises(ValueError, match="coeff_s"):
        lbfgs_ring.combine_kernel(
            s, s, g, torch.zeros(3), torch.zeros(4), torch.tensor(1.0),
        )
    with pytest.raises(ValueError, match="gamma"):
        lbfgs_ring.combine_kernel(
            s, s, g, torch.zeros(4), torch.zeros(4), torch.ones(1),
        )


@pytest.mark.parametrize(("m", "n", "n_sm"), [
    (100, 786432, 132), (100, 1572864, 132), (100, 5883, 132),
    (5, 5883, 132), (103, 12288, 132), (104, 12288, 132),
    (150, 5883, 132), (100, 64, 132), (1, 1, 132), (500, 999, 8),
])
def test_products_plan_covers_the_ring(m, n, n_sm) -> None:
    plan = lbfgs_ring.products_plan(m, n, n_sm)
    stages = -(-n // lbfgs_ring.STAGE_COLUMNS)
    assert plan.tiles_a * lbfgs_ring.TILE_ROWS >= 2 * m
    assert (plan.tiles_a - 1) * lbfgs_ring.TILE_ROWS < 2 * m
    assert plan.tiles_b * lbfgs_ring.TILE_COLS >= m + 1
    assert (plan.tiles_b - 1) * lbfgs_ring.TILE_COLS < m + 1
    # Every stage in one split, no split empty, about one block an SM.
    assert plan.splits * plan.stages_per_split >= stages
    assert (plan.splits - 1) * plan.stages_per_split < stages
    assert plan.splits <= max(1, n_sm // plan.tiles)
    assert plan.group * plan.groups >= plan.splits
    assert (plan.groups - 1) * plan.group < plan.splits
    assert plan.group <= plan.splits or plan.splits == 1
    assert plan.counters == plan.tiles * (plan.groups + 1)
    if plan.splits == 1:
        assert plan.workspace_floats == 0
    else:
        assert plan.workspace_floats == (
            plan.tiles * (plan.splits + plan.groups) * lbfgs_ring.FRAG_FLOATS
        )


def test_products_plan_at_512() -> None:
    # One tile (the ring read once), 131 splits of 94 stages on 132 SMs,
    # summed in 11 groups of 12.
    plan = lbfgs_ring.products_plan(100, 3 * 512 * 512, 132)
    assert (plan.tiles, plan.splits, plan.stages_per_split) == (1, 131, 94)
    assert (plan.group, plan.groups) == (12, 11)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_SHAPES = [(100, 786432), (100, 5883), (5, 5883), (5, 786432),
               (150, 5883)]


@pytest.mark.cuda
@pytest.mark.parametrize("ring", sorted(RING_STATES))
@pytest.mark.parametrize(("m", "n"), CARD_SHAPES)
def test_cuda_direction_matches_plain(cuda, m, n, ring) -> None:
    length, pos = RING_STATES[ring](m)
    grad, state = _ring_state(m, n, length, pos, device=cuda, seed=m + n)
    ring_args = (state.s_hist, state.y_hist, grad)
    lbfgs_ring.launches.reset()
    sums = lbfgs_ring.products_kernel(*ring_args)
    _assert_products(sums, *ring_args)
    coeff = optimizers._compact_coefficients(sums, state)
    plain = optimizers._compact_coefficients(
        lbfgs_ring.products_plain(*ring_args), state,
    )
    for got, want in zip(coeff, plain, strict=True):
        gap = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert gap <= DIR_TOL, gap
    d_kernel = lbfgs_ring.combine_kernel(*ring_args, *coeff, state.h_diag)
    d_plain = lbfgs_ring.combine_plain(*ring_args, *coeff, state.h_diag)
    gap = float((d_kernel - d_plain).norm() / d_plain.norm())
    assert gap <= COMBINE_TOL, gap
    # The direction is the two kernels' composition, bit for bit.
    assert torch.equal(_compact_direction(grad, state), d_kernel)
    # Two launches above, then the direction's two.
    torch.cuda.synchronize()
    assert lbfgs_ring.launches.launched() == 4  # noqa: PLR2004
    assert lbfgs_ring.launches.count == 4  # noqa: PLR2004


@pytest.mark.cuda
@pytest.mark.parametrize(("m", "n"), [(100, 786432), (100, 5883)])
def test_cuda_batched_direction_equals_each_single(cuda, m, n) -> None:
    styles = 4
    states = [
        _ring_state(m, n, length, pos, device=cuda, seed=i)
        for i, (length, pos) in enumerate([(m, 37 % m), (1, 1), (0, 0),
                                           (m // 2 + 1, 3)])
    ]
    batched = optimizers.lbfgs_init_batched(
        styles, n, m, cuda, torch.bfloat16,
    )
    for name in LbfgsState.__dataclass_fields__:
        getattr(batched, name).copy_(torch.stack([
            getattr(st, name) for _, st in states
        ]))
    grads = torch.stack([g for g, _ in states])
    together = torch.stack([
        _compact_direction(g, _style(batched, i))
        for i, g in enumerate(grads)
    ])
    for i, (g, st) in enumerate(states):
        assert torch.equal(together[i], _compact_direction(g, st)), i


@pytest.mark.cuda
def test_cuda_runs_and_graph_replay_bit_equal(cuda) -> None:
    grad, state = _ring_state(100, 786432, 100, 37, device=cuda, seed=5)
    first = _compact_direction(grad, state)
    assert torch.equal(first, _compact_direction(grad, state))
    out = torch.empty_like(first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(_compact_direction(grad, state))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(_compact_direction(grad, state))
    out.zero_()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


def _card_images(size: int = 64, styles: int = 1):
    rng = np.random.default_rng(3)
    return [
        rng.uniform(size=(1, size, size, 3)).astype(np.float32)
        for _ in range(styles + 1)
    ]


def _card_config(max_iter: int):
    from style_transfer_visualizer_tpu_torch.config import (  # noqa: PLC0415
        HardwareConfig,
        OptimizationConfig,
        StyleTransferConfig,
    )

    return StyleTransferConfig(
        optimization=OptimizationConfig(
            style_layers=[0, 5], content_layers=[2], init_method="content",
            seed=0, allow_random_weights=True, steps=8, lr=0.1,
            lbfgs_max_iter=max_iter, lbfgs_max_eval=max_iter + 1,
        ),
        hardware=HardwareConfig(device="cuda:0"),
    )


@pytest.mark.cuda
@pytest.mark.parametrize(("styles", "max_iter"), [(1, 1), (1, 2), (3, 1)])
def test_cuda_launches_counted_in_a_graphed_run(
    cuda, styles, max_iter,
) -> None:
    from style_transfer_visualizer_tpu_torch import main  # noqa: PLC0415

    content, *style_images = _card_images(styles=styles)
    config = _card_config(max_iter)
    if styles == 1:
        bundle, image = main.prepare_model_and_input(
            content, style_images[0], config,
        )
    else:
        bundle, image = main.prepare_multi_style(
            content, style_images, config,
        )
    lbfgs_ring.launches.reset()
    steps = 5
    # A warm-up step, a capture (it runs nothing), 4 replays.
    bundle.chunked_update_fn(image, bundle.opt_state, steps)
    per_run = 2 * styles * max_iter
    assert lbfgs_ring.launches.launched() == steps * per_run
    # The wrappers ran for the warm-up and the capture only.
    assert lbfgs_ring.launches.count == 2 * per_run
