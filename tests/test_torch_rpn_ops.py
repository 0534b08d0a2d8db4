"""The port's anchor-RPN and RCNN ops against the JAX package, on the CPU.

The OBB conversions and the three coders (values, and the round trips of
tests/test_rpn.py and test_rcnn.py), the anchors and their order, the
padding mask, the matcher (thresholds, low-quality restore, invalid GT and
anchors, ties), the chunked [G, A] IoU (bitwise the whole one), the
balanced sampler with the draws passed in, the batched per-level NMS
(each set's keep mask that of its own NMS), the FPN level at the boundary
cubes, and the rotated / axis-aligned RoI align against JAX and against
tests/fixtures/golden_roi.npz (read as tests/test_roi_align_golden.py
reads it). Tolerances: values rtol 1e-5 (elementwise float32 arithmetic),
RoI features rtol 2e-3 / atol 2e-4; integer outputs and masks equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.models import rpn as jrpn
from nerf_mae_tpu.ops import anchors as janchors
from nerf_mae_tpu.ops import coders as jcoders
from nerf_mae_tpu.ops import nms as jnms
from nerf_mae_tpu.ops import obb as jobb
from nerf_mae_tpu.ops import roi_align as jroi
from nerf_mae_tpu.ops.boxes import box_iou_aabb as jbox_iou
from nerf_mae_torch.models import rpn as trpn
from nerf_mae_torch.ops import anchors, coders, nms, obb, roi_align
from nerf_mae_torch.ops.boxes import box_iou_aabb

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_roi.npz")
STRIDES = (4, 8, 16, 32)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _obb7(rs, n):
    return np.concatenate([rs.uniform(4, 28, (n, 3)), rs.uniform(2, 12, (n, 3)),
                           rs.uniform(-3.0, 3.0, (n, 1))], -1).astype(np.float32)


def _aabb(rs, n, lo=0, span=20, size=(3, 12)):
    a = rs.uniform(lo, lo + span, (n, 3))
    return np.concatenate([a, a + rs.uniform(*size, (n, 3))], -1).astype(np.float32)


# ---------------------------------------------------------------- OBB ops


def test_obb_ops_match_jax():
    rs = np.random.RandomState(0)
    o7 = _obb7(rs, 50)
    o5 = o7[:, [0, 1, 3, 4, 6]]
    o5[:5, 2] = o5[:5, 3]  # w == h keeps theta
    for name, x in (("regular_theta", o5[:, 4] * 3), ("regular_obb", o5), ("obb2poly", o5),
                    ("obb2hbb", o5), ("obb2hbb_3d", o7)):
        close(getattr(obb, name)(t(x)), getattr(jobb, name)(jnp.asarray(x)), msg=name)
    # a square's w > h decision rests on rounding (either angle describes
    # it): squares are held mod pi/2 below, the other rows to JAX's values
    poly = np.asarray(jobb.obb2poly(jnp.asarray(o5[5:])))
    close(obb.rectpoly2obb(t(poly)), jobb.rectpoly2obb(jnp.asarray(poly)), atol=1e-4)
    # the round trip of tests/test_rpn.py: a polygon back to its canonical OBB
    back = obb.rectpoly2obb(obb.obb2poly(t(o5)))
    want = obb.regular_obb(t(o5)).numpy()
    np.testing.assert_allclose(back.numpy()[:, :4], want[:, :4], atol=1e-4)
    d = np.abs(back.numpy()[:, 4] - want[:, 4]) % np.pi
    assert (np.minimum(d, np.pi - d)[5:] < 1e-4).all()
    d = d % (np.pi / 2)
    assert (np.minimum(d, np.pi / 2 - d)[:5] < 1e-4).all()


# ----------------------------------------------------------------- coders


def test_aabb_coder_matches_jax_and_round_trips():
    rs = np.random.RandomState(1)
    anc, gt = _aabb(rs, 40), _aabb(rs, 40, size=(4, 14))
    d = coders.encode_aabb_deltas(t(gt), t(anc))
    close(d, jcoders.encode_aabb_deltas(jnp.asarray(gt), jnp.asarray(anc)))
    deltas = rs.randn(40, 6).astype(np.float32)
    deltas[0, 3:] = 20.0  # past BBOX_XFORM_CLIP
    close(coders.decode_aabb_deltas(t(deltas), t(anc)),
          jcoders.decode_aabb_deltas(jnp.asarray(deltas), jnp.asarray(anc)), atol=1e-3)
    close(coders.decode_aabb_deltas(d, t(anc)), gt, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("theta", [0.0, 0.5, -1.1])
def test_rotated_coder_matches_jax_and_round_trips(theta):
    rs = np.random.RandomState(2)
    rois = _obb7(rs, 30)
    rois[:, 6] = theta
    gt = _obb7(rs, 30)
    gt[:, 6] = np.clip(gt[:, 6], -1.5, 1.5)
    d = coders.encode_rotated_deltas(t(gt), t(rois))
    close(d, jcoders.encode_rotated_deltas(jnp.asarray(gt), jnp.asarray(rois)))
    back = coders.decode_rotated_deltas(d, t(rois))
    close(back, jcoders.decode_rotated_deltas(jnp.asarray(d.numpy()), jnp.asarray(rois)),
          atol=1e-4)
    close(back, gt, atol=1e-4)  # theta in (-pi/2, pi/2] comes back


@pytest.mark.parametrize("theta", [0.0, 0.4, -0.9])
def test_midpoint_offset_coder_matches_jax_and_round_trips(theta):
    rs = np.random.RandomState(3)
    gt = _obb7(rs, 30)
    gt[:, 6] = theta
    anc = _aabb(rs, 30, lo=2, span=16, size=(8, 20))
    d = coders.encode_midpoint_offset(t(gt), t(anc))
    close(d, jcoders.encode_midpoint_offset(jnp.asarray(gt), jnp.asarray(anc)), atol=1e-4)
    deltas = (0.3 * rs.randn(30, 8)).astype(np.float32)
    deltas[:3, 6:] = [[0.7, -0.2], [0.0, 0.0], [-0.6, 0.6]]  # clipped at +-0.5
    close(coders.decode_midpoint_offset(t(deltas), t(anc)),
          jcoders.decode_midpoint_offset(jnp.asarray(deltas), jnp.asarray(anc)), atol=1e-4)
    # the round trip of tests/test_rpn.py
    back = coders.decode_midpoint_offset(d, t(anc)).numpy()
    np.testing.assert_allclose(back[:, :3], gt[:, :3], atol=1e-2)
    np.testing.assert_allclose(back[:, 5], gt[:, 5], atol=1e-2)
    np.testing.assert_allclose(np.sort(back[:, 3:5], 1), np.sort(gt[:, 3:5], 1), atol=0.05)
    dt = np.abs(back[:, 6] - gt[:, 6]) % (np.pi / 2)
    assert (np.minimum(dt, np.pi / 2 - dt) < 0.03).all()


# ---------------------------------------------------------------- anchors


def test_grid_anchors_match_jax():
    for args in ((32, (4, 8, 16, 32)), (32, (8, 16, 32), ((8.0,), (16.0,), (32.0,)),
                                        ((1, 1, 1),)), (40, (4, 8), ((8.0,), (16.0,)),
                                                        ((1, 1, 2), (1, 2, 3)), True)):
        got, want = anchors.grid_anchors(*args), janchors.grid_anchors(*args)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]
    np.testing.assert_array_equal(anchors.base_anchors_for_level((8.0,), ((1, 1, 2),)),
                                  janchors.base_anchors_for_level((8.0,), ((1, 1, 2),)))
    assert trpn.RPNConfig().anchors_per_loc == jrpn.RPNConfig().anchors_per_loc == 13
    a, c, lv, per_level = anchors.grid_anchors(160, STRIDES)
    assert per_level == [832000, 104000, 13000, 1625] and a.shape == (950625, 6)


def test_anchor_order_is_the_heads_flatten_order():
    """The head's channel-last [B, W, L, H, A * C] outputs flatten like
    JAX's on a level whose three extents differ, and on a cubic level the
    flat index of (x, y, z, a) is the anchor centred at stride * (x, y, z)."""
    rs = np.random.RandomState(4)
    a_loc, dim = 13, 8
    logits = [rs.randn(2, 3, 4, 5, a_loc).astype(np.float32),
              rs.randn(2, 2, 1, 3, a_loc).astype(np.float32)]
    deltas = [rs.randn(2, 3, 4, 5, a_loc * dim).astype(np.float32),
              rs.randn(2, 2, 1, 3, a_loc * dim).astype(np.float32)]
    got = trpn._flatten_rpn_outputs([t(x) for x in logits], [t(x) for x in deltas], dim)
    want = jrpn._flatten_rpn_outputs([jnp.asarray(x) for x in logits],
                                     [jnp.asarray(x) for x in deltas], dim)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    anc, centers, _, _ = anchors.grid_anchors(32, (8,), ((8.0,),))
    n, s = 4, 8
    marks = np.zeros((1, n, n, n, a_loc), np.float32)
    x, y, z, a = 3, 1, 2, 7
    marks[0, x, y, z, a] = 1.0
    flat = trpn._flatten_rpn_outputs([t(marks)], [t(np.zeros((1, n, n, n, a_loc * 6)))], 6)[0]
    idx = int(torch.argmax(flat[0]))
    np.testing.assert_array_equal(centers[idx], [x * s, y * s, z * s])
    base = anchors.base_anchors_for_level((8.0,), anchors.DEFAULT_ASPECT_RATIOS)
    np.testing.assert_array_equal(anc[idx] - np.tile(centers[idx], 2), base[a])


def test_padding_mask_matches_jax():
    _, centers, _, _ = anchors.grid_anchors(32, (4, 16))
    sizes = np.array([[32, 32, 32], [10, 29, 17]], np.int32)
    got = anchors.anchor_padding_mask(t(centers), t(sizes))
    want = janchors.anchor_padding_mask(jnp.asarray(centers), jnp.asarray(sizes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].all() and 0 < got[1].sum() < got.shape[1]


# ---------------------------------------------------------------- matcher


def _match_both(q, gv, av, low=0.2, high=0.35, allow=True):
    got = anchors.match_anchors(t(q), t(gv), t(av), low, high, allow)
    want = janchors.match_anchors(jnp.asarray(q), jnp.asarray(gv), jnp.asarray(av), low, high,
                                  allow)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    return got[0].numpy(), got[1].numpy()


def test_matcher_cases_match_jax():
    # thresholds, no restore
    lab, _ = _match_both(np.array([[0.5, 0.25, 0.1, 0.0]], np.float32), np.array([True]),
                         np.ones(4, bool), allow=False)
    np.testing.assert_array_equal(lab, [1, -1, 0, 0])
    # a GT's best anchor below the high threshold is restored
    lab, _ = _match_both(np.array([[0.3, 0.1, 0.05, 0.0]], np.float32), np.array([True]),
                         np.ones(4, bool))
    assert lab[0] == 1
    # invalid GT and padded anchors
    lab, matched = _match_both(np.array([[0.9] * 4, [0.1] * 4], np.float32),
                               np.array([False, True]), np.array([True, True, True, False]))
    assert lab[3] == -1 and (matched[lab == 1] == 1).all()


def test_matcher_on_real_ious_with_ties_matches_jax():
    """Several anchors tie for a GT's best IoU (all restored) and anchors
    tie between GTs (the first wins)."""
    rs = np.random.RandomState(5)
    anc = anchors.grid_anchors(32, STRIDES)[0]
    gt = np.concatenate([_aabb(rs, 5, lo=2, span=16, size=(4, 14)), np.zeros((3, 6))]).astype(
        np.float32)
    gt[1] = gt[0]  # two equal boxes: every anchor ties between them
    gv = np.array([True] * 5 + [False] * 3)
    q = np.asarray(jbox_iou(jnp.asarray(gt), jnp.asarray(anc)))
    av = rs.rand(anc.shape[0]) > 0.1
    lab, matched = _match_both(q, gv, av)
    assert (lab == 1).sum() > 5 and not (matched == 1).any()


def test_chunked_iou_and_assignment_are_bitwise_the_whole():
    rs = np.random.RandomState(6)
    anc = t(anchors.grid_anchors(32, STRIDES)[0])
    gt = t(_aabb(rs, 7, lo=2, span=16, size=(4, 14)))
    whole = box_iou_aabb(gt, anc)
    for chunk in (1000, 4096, 1 << 17):
        assert torch.equal(anchors.anchor_quality(gt, anc, chunk), whole)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(jbox_iou(jnp.asarray(gt.numpy()),
                                                                     jnp.asarray(anc.numpy()))))


@pytest.mark.parametrize("rotated", [False, True])
def test_assign_and_encode_matches_jax(rotated):
    rs = np.random.RandomState(7)
    anc, centers, _, _ = anchors.grid_anchors(32, STRIDES)
    gt = np.stack([_obb7(rs, 6) if rotated else _aabb(rs, 6, lo=2, span=16, size=(4, 14))
                   for _ in range(2)])
    gv = np.ones((2, 6), bool)
    gv[1, 4:] = False
    sizes = np.array([[32, 32, 32], [30, 26, 32]], np.int32)
    av = np.asarray(janchors.anchor_padding_mask(jnp.asarray(centers), jnp.asarray(sizes)))
    jcfg, tcfg = jrpn.RPNConfig(resolution=32, rotated_bbox=rotated), trpn.RPNConfig(
        resolution=32, rotated_bbox=rotated)
    want = jrpn.rpn_assign_and_encode(jcfg, jnp.asarray(anc), jnp.asarray(av), jnp.asarray(gt),
                                      jnp.asarray(gv))
    got = trpn.rpn_assign_and_encode(tcfg, t(anc), t(av), t(gt), t(gv))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert (got[0] == 1).sum() > 0


# ---------------------------------------------------------------- sampler


@pytest.mark.parametrize("counts,quantize,bs", [((10, 100, 20), False, 32),
                                                ((50, 50, 0), False, 32),
                                                ((300, 900, 40), True, 256)])
def test_balanced_sample_with_drawn_uniforms_matches_jax(monkeypatch, counts, quantize, bs):
    """The cases of tests/test_rpn.py, and draws with many ties (quantized
    to 1/64: the stable sorts keep the lower index). JAX's sampler runs on
    the same draws (its uniform replaced by them)."""
    labels = np.array([1.0] * counts[0] + [0.0] * counts[1] + [-1.0] * counts[2], np.float32)
    labels = labels[np.random.RandomState(8).permutation(labels.size)]
    r = np.asarray(jax.random.uniform(jax.random.PRNGKey(sum(counts)), labels.shape))
    if quantize:
        r = (np.floor(r * 64) / 64).astype(np.float32)
    monkeypatch.setattr(janchors.jax.random, "uniform", lambda key, shape: jnp.asarray(r))
    want = janchors.balanced_sample(jax.random.PRNGKey(0), jnp.asarray(labels), bs, 0.5)
    got = anchors.balanced_sample(t(labels), bs, 0.5, draws=t(r))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].sum() == min(counts[0], bs // 2)
    assert not (got[0] & got[1]).any() and not (got[0] | got[1])[t(labels) == -1].any()
    # batched over scenes, drawn from a generator
    gen = torch.Generator().manual_seed(0)
    pos, neg = anchors.balanced_sample(t(np.stack([labels, labels[::-1].copy()])), bs, 0.5,
                                       generator=gen)
    assert (pos.sum(1) == min(counts[0], bs // 2)).all()
    assert ((pos | neg).sum(1) == min(counts[0] + counts[1], bs)).all()


# -------------------------------------------------------- per-level NMS


def _clustered(rs, n, rotated):
    """n candidates jittered around 3 boxes: suppression decides."""
    centres = rs.uniform(8, 24, (3, 3))
    pick = rs.randint(0, 3, n)
    c = centres[pick] + rs.normal(0, 1.5, (n, 3))
    size = rs.uniform(5, 9, (n, 3))
    if rotated:
        return np.concatenate([c, size, rs.normal(0, 0.3, (n, 1))], -1).astype(np.float32)
    return np.concatenate([c - size / 2, c + size / 2], -1).astype(np.float32)


@pytest.mark.parametrize("rotated", [False, True])
def test_batched_level_nms_keeps_what_each_nms_keeps(monkeypatch, rotated):
    """rpn_level_nms runs every level and scene as one padded batch: each
    keep mask equals nms_mask of that set alone (and JAX's), ties and
    invalid candidates included; so does nms_mask over leading dims with a
    cap. The batched suppress matrices, in chunks of a few rows, are
    bitwise each set's own."""
    monkeypatch.setattr(nms, "AABB_PAIRS_PER_CHUNK", 700)
    rs = np.random.RandomState(12)
    cands = []
    for k in (60, 45, 13):
        boxes = np.stack([_clustered(rs, k, rotated) for _ in range(2)])
        scores = rs.rand(2, k).astype(np.float32)
        scores[:, :6] = 0.5  # ties
        cands.append({"boxes": t(boxes), "scores": t(scores), "valid": t(rs.rand(2, k) > 0.15)})
    cfg = trpn.RPNConfig(nms_thresh=0.3, rotated_bbox=rotated)
    keeps = trpn.rpn_level_nms(cfg, cands)
    for c, keep in zip(cands, keeps):
        for i in range(2):
            want = nms.nms_mask(c["boxes"][i], c["scores"][i], 0.3, valid=c["valid"][i])
            assert torch.equal(keep[i], want)
            jw = jnms.nms_mask(jnp.asarray(c["boxes"][i].numpy()), jnp.asarray(
                c["scores"][i].numpy()), 0.3, valid=jnp.asarray(c["valid"][i].numpy()))
            np.testing.assert_array_equal(want.numpy(), np.asarray(jw))
            assert 0 < want.sum() < c["valid"][i].sum()
    b = cands[0]
    sup = nms.suppress_matrix(b["boxes"], 0.3)
    for i in range(2):
        assert torch.equal(sup[i], nms.suppress_matrix(b["boxes"][i], 0.3))
    capped = nms.nms_mask(b["boxes"], b["scores"], 0.3, valid=b["valid"], max_keep=3)
    for i in range(2):
        assert torch.equal(capped[i], nms.nms_mask(b["boxes"][i], b["scores"][i], 0.3,
                                                   valid=b["valid"][i], max_keep=3))


# -------------------------------------------------------------- RoI align


def test_fpn_level_at_the_boundary_cubes_matches_jax():
    sides = np.array([5.0, 10.0, 20.0, 40.0, 80.0, 160.0, 9.999, 10.001, 19.99, 20.01, 39.99,
                      40.01, 79.99, 80.01, 0.0], np.float32)
    boxes7 = np.zeros((len(sides), 7), np.float32)
    boxes7[:, 3:6] = sides[:, None]
    got = roi_align.fpn_level_for_boxes(t(boxes7), canonical_scale=160)
    want = np.asarray(jroi.fpn_level_for_boxes(jnp.asarray(boxes7), canonical_scale=160))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:6], [0, 0, 1, 2, 3, 3])
    aabb = np.concatenate([np.full((len(sides), 3), 3.0), 3.0 + boxes7[:, 3:6]], 1)
    np.testing.assert_array_equal(roi_align.fpn_level_for_boxes(t(aabb)).numpy(), want)
    # non-cubes of cube volume 10^3, 20^3, 40^3 and 80^3, at scale 32 too
    odd = np.zeros((4, 7), np.float32)
    odd[:, 3:6] = [[5, 10, 20], [10, 20, 40], [40, 80, 20], [80, 160, 40]]
    for scale in (160, 32):
        np.testing.assert_array_equal(
            roi_align.fpn_level_for_boxes(t(odd), canonical_scale=scale).numpy(),
            np.asarray(jroi.fpn_level_for_boxes(jnp.asarray(odd), canonical_scale=scale)))


def _pyramid(rs, b=2, c=6, sizes=(8, 4, 2, 1)):
    return [rs.randn(b, s, s, s, c).astype(np.float32) for s in sizes]


def _jax_align(feats, rois, levels, fn, **kw):
    return np.stack([np.asarray(fn([jnp.asarray(f[i]) for f in feats], jnp.asarray(rois[i]),
                                   jnp.asarray(levels[i]), STRIDES, **kw))
                     for i in range(rois.shape[0])])


@pytest.mark.parametrize("rotated", [False, True])
def test_roi_align_matches_jax(rotated):
    """Every level, rotations, RoIs partly and wholly outside the grid,
    batched over scenes, with the gradients w.r.t. the features."""
    rs = np.random.RandomState(9)
    feats = _pyramid(rs)
    n = 40
    if rotated:
        rois = np.stack([_obb7(rs, n) for _ in range(2)])
        rois[:, :3, :3] = [[-3.0, 5, 5], [33, 20, 5], [200, 200, 200]]
        fn_t, fn_j = roi_align.roi_align_rotated_3d, jroi.roi_align_rotated_3d
    else:
        rois = np.stack([_aabb(rs, n, lo=-4, span=30, size=(2, 20)) for _ in range(2)])
        fn_t, fn_j = roi_align.roi_align_3d, jroi.roi_align_3d
    levels = rs.randint(0, 4, (2, n)).astype(np.int32)
    want = _jax_align(feats, rois, levels, fn_j, output_size=3, enlarge_scale=0.2)
    tf = [t(f).requires_grad_(True) for f in feats]
    got = fn_t(tf, t(rois), t(levels), STRIDES, output_size=3, enlarge_scale=0.2)
    assert tuple(got.shape) == (2, n, 3, 3, 3, 6)
    close(got, want, rtol=2e-3, atol=2e-4)
    assert (want == 0).any() and (want != 0).mean() > 0.5
    w = rs.randn(*want.shape).astype(np.float32)
    (got * t(w)).sum().backward()

    def jloss(fs):
        out = jnp.stack([fn_j([f[i] for f in fs], jnp.asarray(rois[i]), jnp.asarray(levels[i]),
                              STRIDES, output_size=3, enlarge_scale=0.2) for i in range(2)])
        return (out * w).sum()

    jgrads = jax.grad(jloss)([jnp.asarray(f) for f in feats])
    for lvl, (g, jg) in enumerate(zip(tf, jgrads)):
        close(g.grad, jg, rtol=2e-3, atol=2e-4, msg=f"d level {lvl}")


def test_roi_align_constant_field_and_bf16_features():
    feats = [torch.full((1, 8, 8, 8, 3), 2.5), torch.full((1, 4, 4, 4, 3), 7.0)]
    rois = t(np.array([[[12.0, 12.0, 12.0, 8.0, 6.0, 4.0, 0.4]] * 2], np.float32))
    out = roi_align.roi_align_rotated_3d(feats, rois, t(np.array([[0, 1]])), (4, 8),
                                         output_size=3, enlarge_scale=0.0)
    np.testing.assert_allclose(out[0, 0].numpy(), 2.5, atol=1e-5)
    np.testing.assert_allclose(out[0, 1].numpy(), 7.0, atol=1e-5)
    out = roi_align.roi_align_rotated_3d([f.to(torch.bfloat16) for f in feats], rois,
                                         t(np.array([[0, 1]])), (4, 8), output_size=3)
    assert out.dtype == torch.float32


@pytest.fixture(scope="module")
def golden():
    f = np.load(FIXTURE)
    feats = [np.moveaxis(f[f"feat_{i}"], 0, -1)[None] for i in range(4)]
    return f, feats


def test_roi_align_on_the_golden_fixture(golden):
    """The fixture of tests/test_roi_align_golden.py: the port equals the
    JAX sampler there, so it carries the same measured agreement with the
    reference's pooling (rotated: correlation > 0.97, centre bins > 0.995)."""
    f, feats = golden
    rois = f["rot_rois"]
    lv = rois[None, :, 0].astype(np.int64)
    got = roi_align.roi_align_rotated_3d([t(x) for x in feats], t(rois[None, :, 1:]), t(lv),
                                         STRIDES, output_size=5, enlarge_scale=0.2)[0]
    want = jroi.roi_align_rotated_3d([jnp.asarray(x[0]) for x in feats],
                                     jnp.asarray(rois[:, 1:]), jnp.asarray(lv[0]), STRIDES,
                                     output_size=5, enlarge_scale=0.2)
    close(got, want, rtol=2e-3, atol=2e-4)
    ours, ref = np.moveaxis(got.numpy(), -1, 1), f["rot_out"]
    assert np.corrcoef(ours.ravel(), ref.ravel())[0, 1] > 0.97
    oc, rc = ours[:, :, 2, 2, 2].ravel(), ref[:, :, 2, 2, 2].ravel()
    assert np.corrcoef(oc, rc)[0, 1] > 0.995
    ra = f["aabb_rois"]
    lo, hi = ra[:, 1:4], ra[:, 4:7]
    ctr, sz = (lo + hi) / 2, hi - lo
    adj = np.concatenate([ctr - 0.3 * sz, ctr + 0.3 * sz], -1)[None].astype(np.float32)
    got = roi_align.roi_align_3d([t(x) for x in feats], t(adj), t(ra[None, :, 0].astype(np.int64)),
                                 STRIDES, output_size=5, enlarge_scale=0.0)[0]
    ours, refa = np.moveaxis(got.numpy(), -1, 1), f["aabb_out"]
    m = refa != 0
    assert np.corrcoef(ours[m].ravel(), refa[m].ravel())[0, 1] > 0.98
