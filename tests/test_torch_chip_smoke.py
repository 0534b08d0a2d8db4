"""CPU tests of chip_smoke.py's host-side helpers: the ptxas summary of the
kernel build, the work / bound arithmetic behind the kernels line,
phase 14's FCOS tower work count, NMS flip counter, clustered NMS
candidates, host scan and parameter groups, phase 15's RPN and RCNN
work counts, configurations and pairwise IoU, and phase 16's feed
helpers: the bytes a step of each feed, the loss agreement of the feeds,
the scenes on disk and the e2e stages' flags, and phase 17's NeRF work
counts and the check that the extracted density sits on the boxes."""

import chip_smoke
import numpy as np
import pytest
import torch

from nerf_mae_torch import kernels, run_rpn, run_rpn_detect
from nerf_mae_torch.ops import nms
from nerf_mae_torch.ops.boxes import box_iou_aabb
from nerf_mae_torch.ops.rotated_iou import iou_3d

PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN4swin9sum_partsEPKfixPf' for 'sm_90a'
ptxas info    : Function properties for _ZN4swin9sum_partsEPKfixPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z4gemmv' for 'sm_90a'
ptxas info    : Function properties for _Z4gemmv
    16 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 1056 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_summary_reads_registers_smem_and_spills(monkeypatch, capsys):
    monkeypatch.setattr(kernels, "BUILD_LOG", {"lib": PTXAS_LOG})
    chip_smoke.ptxas_summary()
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 2
    assert "32 registers, 0 B static smem, 0 B stack, spills 0/0 B" in lines[0]
    assert "255 registers, 1056 B static smem, 16 B stack, spills 12/16 B" in lines[1]


def test_work_and_bound_of_the_block_backward():
    # one stage-2 call at batch 8: FLOPs of the real tokens only
    flops, nbytes = chip_smoke.work("block_bwd", (8, 10, 10, 10, 512), 16, torch.bfloat16)
    assert flops == 8000 * (72 * 512 * 512 + 12 * 64 * 512)
    ms, by = chip_smoke.bound(flops, nbytes, torch.bfloat16)
    assert by == "operations" and abs(ms - flops / 989e12 * 1e3) < 1e-12


def test_cached_build_reads_its_ptxas_report_back(monkeypatch, tmp_path):
    """A library built by an earlier process (its .so already in the build
    directory) is not rebuilt, and its nvcc log kept beside it fills
    BUILD_LOG, so phase 2 still prints registers, smem and spills."""
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels, "BUILD_LOG", {})
    out = kernels._build_dir()
    out.mkdir(parents=True)
    for name in kernels.SOURCES:
        (out / f"lib{name}.so").write_bytes(b"")
        (out / f"lib{name}.log").write_text(PTXAS_LOG)
    assert kernels.build_all() == 0.0
    assert kernels.BUILD_LOG == {name: PTXAS_LOG for name in kernels.SOURCES}


def test_work_and_bound_of_the_swin_s_stage0_block():
    """swin_s at 160^3, batch 8, stage 0 (40^3 tokens, C = 96, 3 heads):
    about 0.127 ms forward and 0.382 ms backward at 989 TFLOP/s, both
    bound by operations."""
    shape, heads = (8, 40, 40, 40, 96), 3
    fwd, fwd_bytes = chip_smoke.work("block", shape, heads, torch.bfloat16)
    bwd, bwd_bytes = chip_smoke.work("block_bwd", shape, heads, torch.bfloat16)
    assert fwd == 512000 * (24 * 96 * 96 + 4 * 64 * 96)
    assert bwd == 512000 * (72 * 96 * 96 + 12 * 64 * 96)
    fwd_ms, fwd_by = chip_smoke.bound(fwd, fwd_bytes, torch.bfloat16)
    bwd_ms, bwd_by = chip_smoke.bound(bwd, bwd_bytes, torch.bfloat16)
    assert fwd_by == bwd_by == "operations"
    assert abs(fwd_ms - 0.1272) < 5e-4 and abs(bwd_ms - 0.3817) < 5e-4


def test_fcos_tower_work_count():
    """The FCOS towers at swin_s 160^3, batch 8: 8 convs of 256 -> 256 over
    40^3 are ~1.8 TFLOP each; all levels with the output convs ~16.6 TFLOP a
    forward."""
    level0_conv = 2 * 27 * 256 * 256 * 40**3 * 8
    assert abs(level0_conv / 1e12 - 1.812) < 1e-3
    flops = chip_smoke.fcos_tower_flops(160, 8)
    assert flops == 73125 * 8 * 2 * 27 * 256 * (8 * 256 + 10)
    assert abs(flops / 1e12 - 16.64) < 0.01


def test_nms_flip_counter():
    """Suppress entries that differ between two devices are counted with the
    largest distance of their IoU from the threshold and the first
    candidate they can decide."""
    a = torch.zeros(4, 4, dtype=torch.bool)
    b = a.clone()
    assert chip_smoke.nms_flips(a, b, lambda j, i: 0.0, 0.3) == (0, 0.0, 4)
    b[0, 2] = True
    b[1, 3] = True
    ious = {(0, 2): 0.3000004, (1, 3): 0.2999990}
    n, worst, first = chip_smoke.nms_flips(a, b, lambda j, i: ious[int(j), int(i)], 0.3)
    assert n == 2 and abs(worst - 1e-6) < 1e-9 and worst < chip_smoke.NMS_FLIP_TOL
    assert first == 2
    ious[1, 3] = 0.25
    assert chip_smoke.nms_flips(a, b, lambda j, i: ious[int(j), int(i)], 0.3)[1] > 1e-2
    b[2, 2] = b[3, 1] = True  # the diagonal and below are never read
    assert chip_smoke.nms_flips(a, b, lambda j, i: ious[int(j), int(i)], 0.3)[0] == 2


def test_clustered_candidates_make_suppression_decide():
    """Candidates jittered around a scene's boxes, graded by their jitter:
    at the FCOS threshold most suppress one another, NMS keeps a small
    share, and both scans (the fixed point on the tensors, the host's over
    the copied matrix) keep the same boxes, in a few rounds."""
    gt = np.zeros((2, 5, 7), np.float32)
    gt[:, :3, :3] = [[10, 10, 10], [30, 12, 20], [18, 30, 8]]
    gt[:, :3, 3:6] = [[6, 8, 5], [10, 4, 6], [5, 5, 9]]
    valid = np.zeros((2, 5), bool)
    valid[:, :3] = True
    valid[1, 2] = False
    boxes, scores = chip_smoke.clustered_candidates(gt, valid, 300, seed=0)
    assert boxes.shape == (2, 300, 7) and scores.shape == (2, 300)
    assert np.all(boxes[..., 3:6] > 0) and np.all((scores > 0) & (scores <= 1))
    # scene 1 draws only around its two valid boxes
    near = np.abs(boxes[1, :, None, :2] - gt[1, None, :2, :2]).max(-1).min(-1)
    assert near.max() < 3 * gt[1, :2, 3:5].max()
    order = nms.sort_desc(torch.from_numpy(scores[0]))
    sup = nms.suppress_matrix(torch.from_numpy(boxes[0])[order], 0.3)
    ok = torch.ones(300, dtype=torch.bool)
    ok[::9] = False
    keep = chip_smoke.host_scan(sup, ok)
    assert sup.sum() > 2000 and 0 < keep.sum() < 300 // 4 and not keep[~ok.numpy()].any()
    np.testing.assert_array_equal(nms.greedy_keep(sup, ok).numpy(), keep)
    assert 2 <= chip_smoke.scan_rounds(sup, ok) < 20


def test_host_scan_and_rounds_on_a_chain():
    """A chain where each box suppresses the next: kept alternately, and the
    fixed point takes one round per link plus one."""
    n = 9
    sup = torch.zeros(n, n, dtype=torch.bool)
    sup[torch.arange(n - 1), torch.arange(1, n)] = True
    ok = torch.ones(n, dtype=torch.bool)
    np.testing.assert_array_equal(chip_smoke.host_scan(sup, ok), np.arange(n) % 2 == 0)
    assert chip_smoke.scan_rounds(sup, ok) == n


def test_detector_parameter_groups():
    group = chip_smoke.det_param_group
    assert group("body.patch_partition.0.weight") == "body.patch_partition"
    assert group("body.stages.2.0.norm.weight") == "body.stages.2.merge"
    assert group("body.stages.2.5.attn.qkv.weight") == "body.stages.2.blocks"
    assert group("body.fpn.lateral3.bias") == "body.fpn"
    assert group("head.cls_tower2.weight") == "head.cls_tower"
    assert group("head.box_gn0.bias") == "head.box_gn"
    assert group("head.scales") == "head.scales"
    cfg = chip_smoke.fcos_config()
    assert (cfg.use_obb, cfg.iou_loss_type, cfg.center_sampling_radius) == (True, "iou", 1.5)
    assert (cfg.pre_nms_top_n, cfg.post_nms_top_n, cfg.nms_thresh, cfg.max_gt) == (
        2500, 2500, 0.3, 64)


def test_rpn_and_rcnn_work_counts():
    """The RPN head at swin_s 160^3, batch 8: each 3^3 conv over 40^3 is
    1.81 TFLOP, the head 4.17 TFLOP a forward with the other levels and the
    1^3 convs; the RCNN head over 8 x 128 RoIs of 5^3 is 0.91 TFLOP."""
    level0_conv = 2 * 27 * 256 * 256 * 40**3 * 8
    assert abs(level0_conv / 1e12 - 1.812) < 1e-3
    flops = chip_smoke.rpn_head_flops(160, 8)
    assert flops == 73125 * 8 * 2 * 256 * (2 * 27 * 256 + 13 * 7)
    assert abs(flops / 1e12 - 4.17) < 0.01
    rcnn = chip_smoke.rcnn_head_flops(8 * 128)
    assert rcnn == 1024 * 125 * 2 * 256 * (2 * 27 * 256 + 8)
    assert abs(rcnn / 1e12 - 0.906) < 1e-3


def test_phase15_runs_the_launch_files_configuration():
    """run_rpn with RPN_FLAGS builds chip_smoke.rpn_config() (head depth 2,
    AABB, smooth-L1, 2500 proposals, NMS 0.3, fg / bg 0.35 / 0.2, 256
    anchors a scene, 64 GT), the flags are launch/train_rpn.sh's, and
    run_rpn_detect's defaults are 128 RoIs of 5^3 over 256 proposals."""
    args = run_rpn.parse_args([*chip_smoke.RPN_FLAGS, "--resolution", str(chip_smoke.RES)])
    cfg = chip_smoke.rpn_config()
    assert run_rpn.rpn_config(args) == cfg
    assert (cfg.conv_depth, cfg.rotated_bbox, cfg.reg_loss_type, cfg.pre_nms_top_n,
            cfg.post_nms_top_n, cfg.nms_thresh, cfg.max_gt) == (2, False, "smooth_l1", 2500,
                                                                  2500, 0.3, 64)
    assert (cfg.fg_iou_thresh, cfg.bg_iou_thresh, cfg.batch_size_per_mesh) == (0.35, 0.2, 256)
    with open("launch/train_rpn.sh") as f:
        launch = " ".join(f.read().split())
    for flag, value in zip(chip_smoke.RPN_FLAGS[::2], chip_smoke.RPN_FLAGS[1::2]):
        assert f"{flag} {value}" in launch
    assert "--backbone_type swin_s --resolution 160" in launch and "--batch_size 8" in launch
    assert "--rotated_bbox" not in launch
    rcnn = run_rpn_detect.rcnn_config(run_rpn_detect.parse_args([]))
    assert (rcnn.rois_per_scene, rcnn.output_size, rcnn.conv_depth, rcnn.rotated) == (
        128, 5, 2, False)
    assert run_rpn_detect.parse_args([]).proposals_per_scene == 256


def test_pair_iou_of_aabbs_and_obbs():
    rs = np.random.RandomState(0)
    lo = rs.uniform(0, 10, (5, 3))
    aabb = torch.from_numpy(np.concatenate([lo, lo + rs.uniform(2, 8, (5, 3))], 1).astype(
        np.float32))
    want = box_iou_aabb(aabb, aabb)
    assert chip_smoke.pair_iou(aabb, 1, 3) == want[1, 3] and want[1, 3] >= 0
    obb = torch.cat([(aabb[:, :3] + aabb[:, 3:]) / 2, aabb[:, 3:] - aabb[:, :3],
                     torch.full((5, 1), 0.3)], 1)
    assert torch.equal(chip_smoke.pair_iou(obb, 0, 2), iou_3d(obb[0], obb[2]))


def test_feed_bytes_per_step():
    """Host feeds copy the grids (float32 or bf16) and the int32 sizes each
    step; device feeds copy only the int64 index vector."""
    grid = 8 * 160 ** 3 * 4
    assert chip_smoke.feed_bytes_per_step("inline", 8, 160) == grid * 4 + 96 == 524_288_096
    assert chip_smoke.feed_bytes_per_step("pipeline", 8, 160) == 524_288_096
    assert chip_smoke.feed_bytes_per_step("host bf16", 8, 160) == grid * 2 + 96
    assert chip_smoke.feed_bytes_per_step("device f32", 8, 160) == 64
    assert chip_smoke.feed_bytes_per_step("device bf16", 8, 160) == 64
    names = [n for n, _ in chip_smoke.FEEDS]
    assert names == ["inline", "pipeline", "device f32", "device bf16"]
    flags = dict(chip_smoke.FEEDS)
    assert flags["inline"] == ("--prefetch", "0", "--workers", "0")
    assert flags["pipeline"] == ("--prefetch", "2", "--workers", "8")
    assert "--transfer_dtype" not in flags["device f32"]
    assert flags["device bf16"][-2:] == ("--transfer_dtype", "bfloat16")


def test_feed_losses_agree_on_crafted_histories():
    base = [5.25, 4.5, 4.0000001]
    ok = {"inline": base, "pipeline": list(base), "device f32": list(base),
          "device bf16": [5.3, 4.49, 4.01]}
    assert chip_smoke.feed_losses_agree(ok) == []
    one_ulp = float(np.nextafter(np.float32(base[2]), np.float32(5)))
    bad = dict(ok, pipeline=[5.25, 4.5, one_ulp])
    assert chip_smoke.feed_losses_agree(bad) == ["pipeline differs from inline"]
    bad = dict(ok, **{"device f32": base[:2]})
    assert chip_smoke.feed_losses_agree(bad) == ["device f32 differs from inline"]
    far = chip_smoke.feed_losses_agree(dict(ok, **{"device bf16": [5.25, 4.5, 4.2]}))
    assert len(far) == 1 and "device bf16 differs from inline by 5.000e-02" in far[0]
    nan = chip_smoke.feed_losses_agree(dict(ok, **{"device bf16": [5.25, float("nan"), 4.0]}))
    assert len(nan) == 1 and "not finite" in nan[0]


def test_feed_scenes_on_disk(tmp_path):
    root = chip_smoke.write_feed_scenes(str(tmp_path / "f"), seed=160, n=3, lo=8)
    files = sorted(p.name for p in (tmp_path / "f").iterdir())
    assert files == ["scene00.npz", "scene01.npz", "scene02.npz"]
    for name in files:
        with np.load(f"{root}/{name}") as f:
            shape = f["rgbsigma"].shape
        assert shape[3] == 4 and all(s % 2 == 1 and 15 <= s <= 159 for s in shape[:3])


def test_e2e_stages_cut_the_recipe_of_the_launch_file():
    with open("launch/e2e_synthetic_ap_torch.sh") as f:
        recipe = f.read()
    for flag in ("--synthetic_hard", "--device_data", "--transfer_dtype bfloat16",
                 "python -m nerf_mae_torch.run_mae_pretrain", "python -m nerf_mae_torch.run_fcos",
                 "--seed 77", "--lr 3e-4", "--lr 1e-4"):
        assert flag in recipe
    e = chip_smoke.E2E
    assert (e["res"], e["backbone"], e["scenes"], e["val_scenes"]) == (96, "swin_s", 32, 8)
    assert (e["mae_steps"], e["det_steps"]) == (60, 40)


def test_nerf_work_counts_and_the_step_bound():
    """Phase 17's work: 591,488 MACs a point of the 8x256 NeRF (the fc
    layers 60x256, 4x 256x256, 316x256, 2x 256x256; sigma and feat 256 ->
    1 + 256; color 280 -> 128; rgb 128 -> 3), a hierarchical step of 4096
    x (64 + 128) points 2.79 TFLOP, 41.7 ms at the float32 peak."""
    assert chip_smoke.nerf_point_macs() == 591488
    assert chip_smoke.nerf_point_macs(cam_dim=16) == 591488 + 16 * 128
    tiny = chip_smoke.nerf_point_macs(depth=3, width=48, skip_at=1, pos_freqs=5, dir_freqs=2)
    assert tiny == 30 * 48 + 48 * 48 + 78 * 48 + 48 * 49 + (48 + 12) * 24 + 24 * 3
    flops = chip_smoke.nerf_step_flops(4096, 64 + 128)
    assert flops == 6 * 786432 * 591488
    assert round(flops / chip_smoke.PEAK_FLOPS[torch.float32] * 1e3, 1) == 41.7
    # extraction: trunk + color_fc's feature columns per point, the rest per view
    assert chip_smoke.nerf_extract_flops(1, 0) == 2 * (555264 + 256 * 128)
    assert chip_smoke.nerf_extract_flops(10, 96) == 10 * (
        2 * (555264 + 256 * 128) + 96 * (2 * 128 * 3 + 2 * 128 + 12))


def test_density_on_boxes_passes_on_the_boxes_and_fails_off_them():
    grid = np.zeros((40, 40, 20, 4), np.float32)
    grid[8:14, 10:16, 4:10, 3] = 9.0
    grid[28:32, 26:30, 10:14, 3] = 8.0
    boxes = np.array([[11.0, 13.0, 7.0, 6, 6, 6, 0], [30.0, 28.0, 12.0, 4, 4, 4, 0]])
    dist = chip_smoke.density_on_boxes(grid, boxes, scale=1.0)
    assert max(dist) < 1e-6
    with pytest.raises(AssertionError, match="no density near"):
        chip_smoke.density_on_boxes(grid, boxes - np.array([[0, 0, 0, 0, 0, 0, 0],
                                                            [9, 0, 0, 0, 0, 0, 0]]), scale=1.0)
    shifted = boxes + np.array([[4.0, 0, 0, 6, 6, 6, 0], [0, 0, 0, 0, 0, 0, 0]])  # blob 4 off
    with pytest.raises(AssertionError, match="off the density"):
        chip_smoke.density_on_boxes(grid, shifted, scale=1.0)
    with pytest.raises(AssertionError, match="no positive density"):
        chip_smoke.density_on_boxes(np.zeros_like(grid), boxes, scale=1.0)
