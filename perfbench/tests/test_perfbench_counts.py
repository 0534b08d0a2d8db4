"""The frozen counts equal the system's own today: the MAE's model FLOPs
(nerf_mae_torch/flops.py) and the fused block's operations, bytes and
bound (chip_smoke.py's work / bound), so that a later edit of either does
not move the yardstick unseen."""

import json

import pytest
import torch

from perfbench import counts, spec
from perfbench.tests import tiny


def _cfg(name):
    return json.loads((spec.ROOT / "perfbench/configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("size", ["cell", "tiny"])
def test_mae_flops_equal_the_port(size):
    from nerf_mae_torch import flops
    from nerf_mae_torch.config import MAEConfig, SwinConfig
    c = _cfg("mae_swin_b_160")
    if size == "tiny":
        c.update(tiny.TRUNK)
    swin = SwinConfig(embed_dim=c["embed_dim"], depths=tuple(c["depths"]),
                      num_heads=tuple(c["num_heads"]), patch_size=(c["patch_size"],) * 3,
                      window_size=tuple(c["window_size"]), mlp_ratio=c["mlp_ratio"])
    port = flops.mae_flops_per_grid(MAEConfig(swin=swin, resolution=c["resolution"]))
    ours = counts.mae_flops_per_grid(c)
    assert ours.keys() == port.keys()
    for k, v in port.items():
        assert ours[k] == pytest.approx(v, rel=1e-12), k
    assert ours["train_total"] == pytest.approx(3 * ours["fwd_total"])


def test_fcos_flops_share_the_trunk():
    c = _cfg("fcos_swin_s_160_obb")
    fcos = counts.fcos_flops_per_grid(c)
    for k, v in counts.trunk_flops(c).items():
        assert fcos[k] == v
    t, f = 40, c["fpn_channels"]
    levels = [t ** 3, (t // 2) ** 3, (t // 4) ** 3, (t // 8) ** 3]
    assert fcos["towers"] == sum(2.0 * n * 27 * f * f * 8 for n in levels)
    assert fcos["predictors"] == sum(2.0 * n * 27 * f * 10 for n in levels)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_block_work_and_bound_equal_chip_smoke(kind):
    import chip_smoke
    for stages in (chip_smoke.STAGES, chip_smoke.SWIN_S_STAGES):
        for g, c, heads in stages.values():
            for b in (1, 8):
                shape = (b, g, g, g, c)
                theirs = chip_smoke.work("block" if kind == "fwd" else "block_bwd", shape, heads,
                                         torch.bfloat16)
                ours = counts.block_work(kind, shape, heads, "bfloat16")
                assert ours == theirs
                ms, _ = chip_smoke.bound(*theirs, torch.bfloat16)
                assert counts.bound_s(*ours, "bfloat16") * 1e3 == pytest.approx(ms, rel=1e-12)


def test_fused_block_calls_match_the_trunk():
    mae = counts.fused_block_calls(_cfg("mae_swin_b_160"), 8)
    assert len(mae) == 22 and {s[-1] for s, _ in mae} == {128, 256, 512}
    fcos = counts.fused_block_calls(_cfg("fcos_swin_s_160_obb"), 8)
    assert len(fcos) == 22 and {s[-1] for s, _ in fcos} == {96, 192, 384}
