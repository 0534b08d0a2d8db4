"""Where the fused Swin block keeps the rows its backward reads, on the CPU.

FusedSwinBlockFn keeps them (fused_swin_block(keep_rows=True)) only where
autograd will call its backward: grad mode on where it is applied and some
input needing a gradient. Under no_grad, inference_mode, with every input
frozen, in a served forward and in the RCNN's frozen first stage it keeps
nothing, and `fused_swin_block.kept` / `.kept_bytes` (listed by
tracing.counters() and the profile table) do not move. On CPU tensors the
plain versions run and keep the same rows, so the decision and the counts
are the card's. The kept rows' gradients against JAX:
tests/test_torch_fused_block_bwd.py; on the card:
tests/test_torch_cuda_kernels.py.
"""

import contextlib
import dataclasses

import pytest
import torch

from nerf_mae_torch import run_rpn_detect, tracing
from nerf_mae_torch.models.swin import SwinBlock3D
from nerf_mae_torch.ops.fused_block import (
    FusedSwinBlockFn,
    fused_swin_block,
    fused_swin_block_plain,
    row_views,
    row_widths,
)

torch.set_num_threads(1)
WINDOW, SHIFT, HEADS, C = (4, 4, 4), (2, 2, 2), 2, 16
SHAPE = (2, 6, 6, 6, C)  # padded to 8^3
ROWS = 2 * 8 ** 3  # a multiple of 128: the row sets need no alignment gap
KEPT_BYTES = ROWS * sum(row_widths(C, 4 * C)) * 4  # float32


def _inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)
    params = [1 + 0.1 * r(C), 0.1 * r(C), r(3 * C, C) / C ** 0.5, 0.1 * r(3 * C),
              r(C, C) / C ** 0.5, 0.1 * r(C), 1 + 0.1 * r(C), 0.1 * r(C),
              r(4 * C, C) / C ** 0.5, 0.1 * r(4 * C), r(C, 4 * C) / (2 * C ** 0.5),
              0.1 * r(C), r(343, HEADS)]
    keep = torch.tensor([[1 / 0.9, 0.0], [1.0, 1 / 0.9]])
    return r(*SHAPE), params, keep


def _kept():
    return fused_swin_block.kept, fused_swin_block.kept_bytes


# case: (what needs a gradient, the mode it is applied in, whether it keeps)
CASES = {
    "x_needs_grad": ("x", contextlib.nullcontext, True),
    "a_parameter_needs_grad": ("param", contextlib.nullcontext, True),
    "no_grad": ("all", torch.no_grad, False),
    "inference_mode": ("all", torch.inference_mode, False),
    "every_input_frozen": ("none", contextlib.nullcontext, False),
}


@pytest.mark.parametrize("case", CASES)
def test_rows_kept_only_where_a_backward_follows(case):
    needs, mode, keeps = CASES[case]
    x, params, keep = _inputs()
    x.requires_grad_(needs in ("x", "all"))
    for i, p in enumerate(params):
        p.requires_grad_(needs == "all" or (needs == "param" and i == 2))
    before = _kept()
    with mode():
        out = FusedSwinBlockFn.apply(x, *params, keep, WINDOW, SHIFT, HEADS, 1e-5)
    assert _kept() == ((before[0] + 1, before[1] + KEPT_BYTES) if keeps else before)
    assert out.requires_grad == keeps
    if keeps:
        out.square().sum().backward()
        grads = [t.grad for t in (x, *params) if t.requires_grad]
        assert grads and all(g is not None and g.abs().max() > 0 for g in grads)
        assert _kept()[0] == before[0] + 1  # the backward reads, keeps nothing


def test_kept_rows_leave_the_forward_unchanged():
    """The keeping forward gives the same output as one that keeps nothing,
    and keeps one buffer of the row sets [M, width] in window order with
    the pad rows: h1 is zero there, qkv holds the scaled q."""
    x, params, keep = _inputs(1)
    static = (WINDOW, SHIFT, HEADS, 1e-5)
    before = _kept()
    out, rows = fused_swin_block(x, *params, keep, *static, keep_rows=True)
    assert _kept() == (before[0] + 1, before[1] + KEPT_BYTES)
    assert torch.equal(out, fused_swin_block_plain(x, *params, keep, *static))
    assert rows.shape == (ROWS * sum(row_widths(C, 4 * C)),)
    views = row_views(rows, ROWS, C, 4 * C)
    assert [tuple(r.shape) for r in views] == [(ROWS, w) for w in row_widths(C, 4 * C)]
    h1, qkv = views[0], views[1]
    ones = fused_swin_block_plain(torch.ones(SHAPE), *params, keep, *static, keep_rows=True)[1]
    pad = (row_views(ones, ROWS, C, 4 * C)[0] == 0).all(-1)  # LN of a constant row: its bias
    assert pad.sum() == ROWS - 2 * 6 ** 3
    assert (h1[pad] == 0).all() and (h1[~pad] != 0).any()
    q = torch.nn.functional.linear(h1, params[2][:C], params[3][:C]) * (C // HEADS) ** -0.5
    torch.testing.assert_close(qkv[..., :C], q, rtol=1e-5, atol=1e-5)


def test_swin_block_keeps_rows_only_in_training():
    """A kernel block (tanh GELU) keeps its rows in a training forward, not in
    a served one, nor with its parameters frozen and an input that needs no
    gradient."""
    torch.manual_seed(0)
    block = SwinBlock3D(C, HEADS, WINDOW, SHIFT, dtype=torch.float32,
                        attention_impl="kernel", device="cpu")
    x = torch.randn(*SHAPE)
    before = _kept()
    block(x).sum().backward()
    assert _kept()[0] == before[0] + 1
    with torch.no_grad():
        block(x)
    block.requires_grad_(False)
    assert not block(x).requires_grad
    assert _kept()[0] == before[0] + 1


def test_frozen_rpn_body_keeps_no_rows(monkeypatch):
    """The RCNN's first stage: its body's kernel blocks keep nothing in
    features_and_proposals (no_grad), and keep their rows once a gradient is
    wanted through the same body."""
    nano = run_rpn_detect.SWIN_PRESETS["swin_nano"]
    monkeypatch.setitem(run_rpn_detect.SWIN_PRESETS, "swin_nano",
                        dataclasses.replace(nano, attention_impl="kernel"))
    args = run_rpn_detect.parse_args(
        ["--backbone_type", "swin_nano", "--resolution", "32", "--batch_size", "2",
         "--compute_dtype", "float32", "--device", "cpu", "--max_gt", "8",
         "--proposals_per_scene", "32"])
    state = run_rpn_detect.frozen_rpn(args, torch.device("cpu"))
    grids = torch.rand(2, 32, 32, 32, 4, generator=torch.Generator().manual_seed(2))
    before = _kept()
    run_rpn_detect.features_and_proposals(state, {"grids": grids, "sizes": torch.full((2, 3), 32)})
    assert _kept() == before
    state.model.body(grids)
    assert _kept()[0] > before[0]


def test_counters_list_the_kept_rows():
    """tracing.counters() and the profile table (`--profile_dir`) list
    fused_swin_block.kept and .kept_bytes beside the launches."""
    x, params, keep = _inputs(3)
    x.requires_grad_()
    counters = tracing.counters()
    assert counters["fused_swin_block.kept"] == fused_swin_block.kept
    assert counters["fused_swin_block.kept_bytes"] == fused_swin_block.kept_bytes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        FusedSwinBlockFn.apply(x, *params, keep, WINDOW, SHIFT, HEADS, 1e-5)
        table = tracing.table(None, before=counters)
    assert table["counters"]["fused_swin_block.kept"] == 1
    assert table["counters"]["fused_swin_block.kept_bytes"] == KEPT_BYTES
    assert "fused_swin_block.kept 1" in tracing.format_table(table)
