"""The port's detection ops against the JAX package and the golden
fixture, on the CPU.

Every op of ops/boxes.py, rotated_iou.py, fcos_box.py, fcos_targets.py,
nms.py and projection.py against its JAX function from the same numpy
inputs (forward rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-5, or
exact where the op is a selection); the per-[B, G] box quantities of the
target assignment against the broadcast [B, L, G] form (exact); the chunked
pairwise IoU against one whole call (exact); the NMS keep mask and top-k on
boxes with many tied scores (exact). Then the port directly against
tests/fixtures/golden_det.npz at the tolerances of
tests/test_parity_golden_det.py: rotated IoU / GIoU / DIoU, the pairwise
matrices, NMS at 0.25 and 0.5, the eval suite, the FCOS targets, the full
loss (AABB and OBB), the post-processing and the 2D projection.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.eval import detection as jeval
from nerf_mae_tpu.ops import boxes as jboxes
from nerf_mae_tpu.ops import fcos_box as jfbox
from nerf_mae_tpu.ops import fcos_targets as jtargets
from nerf_mae_tpu.ops import nms as jnms
from nerf_mae_tpu.ops import projection as jproj
from nerf_mae_tpu.ops import rotated_iou as jriou
from nerf_mae_torch.eval import detection as teval
from nerf_mae_torch.models.fcos import FCOSConfig, fcos_loss, fcos_postprocess
from nerf_mae_torch.ops import boxes, fcos_box, fcos_targets, nms, projection, rotated_iou

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_det.npz")


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def random_obbs(n, seed, spread=20.0, size=(2.0, 10.0)):
    """[n, 7] boxes near the origin, so that many pairs overlap."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(0, spread, (n, 3))
    s = rs.uniform(*size, (n, 3))
    th = rs.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([c, s, th], 1).astype(np.float32)


def random_aabbs(n, seed, spread=20.0):
    rs = np.random.RandomState(seed)
    lo = rs.uniform(0, spread, (n, 3))
    return np.concatenate([lo, lo + rs.uniform(1, 8, (n, 3))], 1).astype(np.float32)


def grads_match(jfn, tfn, *arrays, msg=""):
    """Value and the gradient of sum(f * w) for a fixed random w, w.r.t.
    every input, JAX against the port."""
    rs = np.random.RandomState(7)
    jout = jfn(*arrays)
    w = np.asarray(rs.randn(*np.shape(jout)), np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(arrays))))(*arrays)
    ts = [t(a).clone().requires_grad_(True) for a in arrays]
    tout = tfn(*ts)
    close(tout, jout, msg=f"{msg} value")
    (tout * t(w)).sum().backward()
    for i, (a, g) in enumerate(zip(ts, jg)):
        close(a.grad, g, GRAD_RTOL, GRAD_ATOL, msg=f"{msg} grad {i}")


# ------------------------------------------------------------------ boxes


def test_aabb_ops_match_jax():
    a, b = random_aabbs(30, 0), random_aabbs(40, 1)
    close(boxes.box_volume(t(a)), jboxes.box_volume(a))
    close(boxes.box_iou_aabb(t(a), t(b)), jboxes.box_iou_aabb(a, b))
    size = np.array([15.0, 12.0, 18.0], np.float32)
    close(boxes.clip_boxes_to_grid(t(a), t(size)), jboxes.clip_boxes_to_grid(a, size))
    np.testing.assert_array_equal(boxes.small_box_mask(t(a), 4.0).numpy(),
                                  np.asarray(jboxes.small_box_mask(a, 4.0)))
    o = random_obbs(30, 2)
    np.testing.assert_array_equal(boxes.small_box_mask(t(o), 4.0).numpy(),
                                  np.asarray(jboxes.small_box_mask(o, 4.0)))
    close(boxes.aabb_to_obb(t(a)), jboxes.aabb_to_obb(a))
    close(boxes.obb_to_aabb(t(o)), jboxes.obb_to_aabb(o))


# ------------------------------------------------------------ rotated IoU


def test_box2corners_and_iou_3d_match_jax_with_gradients():
    b1, b2 = random_obbs(64, 3), random_obbs(64, 4)
    close(rotated_iou.box2corners(t(b1[:, [0, 1, 3, 4, 6]])),
          jriou.box2corners(b1[:, [0, 1, 3, 4, 6]]))
    iou = np.asarray(jriou.iou_3d(b1, b2))
    assert (iou > 0).sum() > 10  # the pairs overlap enough to test the polygon
    grads_match(jriou.iou_3d, rotated_iou.iou_3d, b1, b2, msg="iou_3d")


@pytest.mark.parametrize("loss", ["giou", "diou"])
@pytest.mark.parametrize("enclosing", ["smallest", "aligned"])
def test_giou_diou_losses_match_jax_with_gradients(loss, enclosing):
    b1, b2 = random_obbs(48, 5), random_obbs(48, 6)
    jf = {"giou": jriou.giou_3d_loss, "diou": jriou.diou_3d_loss}[loss]
    tf = {"giou": rotated_iou.giou_3d_loss, "diou": rotated_iou.diou_3d_loss}[loss]
    grads_match(lambda a, b: jf(a, b, enclosing), lambda a, b: tf(a, b, enclosing), b1, b2,
                msg=f"{loss} {enclosing}")


def test_pairwise_iou_matches_jax_and_chunks_change_nothing():
    b1, b2 = random_obbs(37, 7), random_obbs(29, 8)
    whole = rotated_iou.box_iou_obb_pairwise(t(b1), t(b2), pairs_per_chunk=1 << 30)
    close(whole, jriou.box_iou_obb_pairwise(b1, b2))
    for chunk in (1, 29, 100, 29 * 5 + 3):
        got = rotated_iou.box_iou_obb_pairwise(t(b1), t(b2), pairs_per_chunk=chunk)
        assert torch.equal(got, whole), chunk


@pytest.mark.parametrize("spread", [80.0, 25.0, 6.0])
def test_suppress_matrix_skips_only_pairs_of_iou_zero(spread):
    """For OBBs the suppress matrix computes the rotated IoU only where the
    extents overlap, and only above the diagonal (what the greedy scan
    reads): equal to that triangle of the thresholded whole matrix, at a
    threshold of 0 too (any pair skipped with an IoU above 0 would show),
    with touching and identical boxes among them."""
    b = random_obbs(150, 26, spread=spread, size=(0.5, 12.0))
    b[1] = b[0]
    b[3] = b[2]
    b[3, 0] += b[2, 3]  # side by side, touching when axis-aligned
    b[2, 6] = b[3, 6] = 0.0
    bt = t(b)
    whole = rotated_iou.box_iou_obb_pairwise(bt, bt)
    for thr in (0.0, 0.3):
        want = torch.triu(whole > thr, diagonal=1)
        assert torch.equal(nms.suppress_matrix(bt, thr), want), thr
        assert torch.equal(nms.suppress_matrix(bt, thr, pairs_per_chunk=999), want)
    aabb = t(random_aabbs(90, 27, spread=spread))
    assert torch.equal(nms.suppress_matrix(aabb, 0.2, pairs_per_chunk=500),
                       torch.triu(boxes.box_iou_aabb(aabb, aabb) > 0.2, diagonal=1))
    with pytest.raises(ValueError):  # a negative threshold would suppress disjoint pairs
        nms.suppress_matrix(bt, -0.1)


def test_smallest_enclosing_box_matches_jax():
    b1, b2 = random_obbs(32, 9), random_obbs(32, 10)
    c1 = b1[:, [0, 1, 3, 4, 6]]
    c2 = b2[:, [0, 1, 3, 4, 6]]
    grads_match(
        lambda a, b: jnp.stack(jriou.smallest_enclosing_box_2d(
            jriou.box2corners(a), jriou.box2corners(b)), -1),
        lambda a, b: torch.stack(rotated_iou.smallest_enclosing_box_2d(
            rotated_iou.box2corners(a), rotated_iou.box2corners(b)), -1),
        c1, c2, msg="smallest enclosing")


# ---------------------------------------------------------------- FCOS box


def test_fcos_box_coders_match_jax_with_gradients():
    rs = np.random.RandomState(11)
    locs = rs.uniform(0, 20, (40, 3)).astype(np.float32)
    a = random_aabbs(40, 12)
    o = random_obbs(40, 13)
    close(fcos_box.encode_fcos_aabb(t(locs), t(a)), jfbox.encode_fcos_aabb(locs, a))
    close(fcos_box.obb_footprint_aabb(t(o)), jfbox.obb_footprint_aabb(o))
    close(fcos_box.encode_fcos_obb(t(locs), t(o)), jfbox.encode_fcos_obb(locs, o))
    # axis-aligned boxes exercise the reference's near-AABB corner case
    o0 = o.copy()
    o0[:10, 6] = 0.0
    o0[10:20, 6] = np.pi / 2
    close(fcos_box.encode_fcos_obb(t(locs), t(o0)), jfbox.encode_fcos_obb(locs, o0))
    grads_match(jfbox.decode_fcos_aabb, fcos_box.decode_fcos_aabb, locs,
                rs.uniform(0, 5, (40, 6)).astype(np.float32), msg="decode aabb")
    off = np.concatenate([rs.uniform(0.5, 5, (40, 6)), rs.uniform(-0.5, 0.5, (40, 2))],
                         1).astype(np.float32)
    grads_match(jfbox.decode_fcos_obb, fcos_box.decode_fcos_obb, locs, off, msg="decode obb")
    # degenerate offsets (a zero-size footprint): the guards keep the
    # gradient finite, as in JAX
    off[:5, :6] = 0.0
    off[:5, 6:] = 0.0
    grads_match(jfbox.decode_fcos_obb, fcos_box.decode_fcos_obb, locs, off,
                msg="decode obb degenerate")


# -------------------------------------------------------- target assignment


def _gt(use_obb, seed, b=2, g=6, res=32):
    rs = np.random.RandomState(seed)
    if use_obb:
        c = rs.uniform(6, res - 6, (b, g, 3))
        s = rs.uniform(3, 14, (b, g, 3))
        th = rs.uniform(-np.pi, np.pi, (b, g, 1))
        th[:, :2] = 0.0  # axis-aligned ones too
        gt = np.concatenate([c, s, th], -1)
    else:
        lo = rs.uniform(0, res - 12, (b, g, 3))
        gt = np.concatenate([lo, lo + rs.uniform(3, 14, (b, g, 3))], -1)
    gt[1, 1] = gt[1, 0]  # two identical boxes: equal volumes tie
    valid = np.ones((b, g), bool)
    valid[0, -2:] = False
    return gt.astype(np.float32), valid


def test_level_locations_match_jax():
    got = fcos_targets.level_locations((32, 28, 36), (4, 8, 16, 32))
    want = jtargets.level_locations((32, 28, 36), (4, 8, 16, 32))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_obb", [False, True])
@pytest.mark.parametrize("radius", [1.5, 0.0])
def test_assign_fcos_targets_matches_jax(use_obb, radius):
    _, locs, strides, ranges = jtargets.level_locations((32, 32, 32), (4, 8, 16, 32))
    gt, valid = _gt(use_obb, seed=14 + int(use_obb))
    jl, jr = jtargets.assign_fcos_targets(locs, strides, ranges, gt, valid, radius, use_obb)
    tl, tr = fcos_targets.assign_fcos_targets(t(locs), t(strides), t(ranges), t(gt), t(valid),
                                              radius, use_obb)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.sum() > 10
    close(tr, jr, rtol=1e-6, atol=1e-5)
    close(fcos_targets.centerness_targets(tr), jtargets.centerness_targets(jr), rtol=1e-5)


@pytest.mark.parametrize("use_obb", [False, True])
def test_per_box_targets_equal_the_broadcast_form(use_obb):
    """The assignment makes each box's corners, footprint and midpoint
    offsets once per [B, G]; built the JAX way (every box broadcast to
    [B, L, G] and encoded per location) the numbers are bitwise the same."""
    _, locs, strides, ranges = fcos_targets.level_locations((32, 32, 32), (4, 8, 16, 32))
    locs, strides, ranges = t(locs), t(strides), t(ranges)
    gt, valid = _gt(use_obb, seed=16)
    gt, valid = t(gt), t(valid)
    b, g = gt.shape[:2]
    l = locs.shape[0]
    locs_e = locs[None, :, None, :].expand(b, l, g, 3)
    boxes_e = gt[:, None].expand(b, l, g, gt.shape[-1])
    if use_obb:
        reg = fcos_box.encode_fcos_obb(locs_e, boxes_e)  # corners per location
        aabbs = fcos_box.obb_footprint_aabb(gt)
    else:
        reg = fcos_box.encode_fcos_aabb(locs_e, boxes_e)
        aabbs = gt
    center = (aabbs[..., :3] + aabbs[..., 3:6]) / 2
    r = (strides * 1.5)[None, :, None, None]
    lo = torch.maximum(center[:, None] - r, aabbs[:, None, :, 0:3])
    hi = torch.minimum(center[:, None] + r, aabbs[:, None, :, 3:6])
    le = locs[None, :, None, :]
    is_in = torch.cat([le - lo, hi - le], -1).amin(-1) > 0
    max_off = reg[..., :6].amax(-1)
    in_level = (max_off >= ranges[None, :, 0:1]) & (max_off <= ranges[None, :, 1:2])
    whd = aabbs[..., 3:6] - aabbs[..., :3]
    cost = torch.where(is_in & in_level & valid[:, None, :],
                       (whd[..., 0] * whd[..., 1] * whd[..., 2])[:, None, :].expand(b, l, g),
                       torch.tensor(fcos_targets.INF))
    best = cost.argmin(-1)
    want_labels = (cost.gather(-1, best[..., None])[..., 0] < fcos_targets.INF).float()
    want_reg = reg.gather(2, best[..., None, None].expand(b, l, 1, reg.shape[-1]))[:, :, 0]
    labels, got_reg = fcos_targets.assign_fcos_targets(locs, strides, ranges, gt, valid, 1.5,
                                                       use_obb)
    assert torch.equal(labels, want_labels)
    assert torch.equal(got_reg, want_reg)


# --------------------------------------------------------------------- NMS


def _tied_scores(n, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 6, n).astype(np.float32) / 5  # many equal scores


@pytest.mark.parametrize("use_obb", [False, True])
@pytest.mark.parametrize("max_keep", [None, 7])
def test_nms_mask_matches_jax_with_ties(use_obb, max_keep):
    n = 90
    bx = random_obbs(n, 17, spread=12.0) if use_obb else random_aabbs(n, 17, spread=12.0)
    scores = _tied_scores(n, 18)
    valid = np.random.RandomState(19).rand(n) > 0.2
    for thr in (0.1, 0.3):
        want = np.asarray(jnms.nms_mask(bx, scores, thr, valid=jnp.asarray(valid),
                                         max_keep=max_keep))
        got = nms.nms_mask(t(bx), t(scores), thr, valid=t(valid), max_keep=max_keep)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"thr {thr}")
        assert 0 < want.sum() < valid.sum()


@pytest.mark.parametrize("case", ["random", "chain", "cluster"])
def test_greedy_keep_is_the_jax_scan(case):
    """The fixed-point scan against the JAX fori_loop body, literally, on
    random suppressions, a chain of 150 (each box suppresses the next: the
    longest dependency, 150 rounds) and a dense cluster."""
    rs = np.random.RandomState(20)
    n = 160
    suppress = rs.rand(n, n) > {"random": 0.8, "chain": 1.1, "cluster": 0.3}[case]
    if case == "chain":
        suppress[np.arange(150), np.arange(1, 151)] = True
    valid = rs.rand(n) > 0.05
    keep = np.zeros(n, bool)
    for i in range(n):
        killed = np.any(keep & suppress[:, i] & (np.arange(n) < i))
        keep[i] = valid[i] and not killed
    np.testing.assert_array_equal(nms.greedy_keep(t(suppress), t(valid)).numpy(), keep)


def test_topk_breaks_ties_toward_the_lower_index():
    scores = np.array([[1, 2, 2, 1, 3, 2, -np.inf, 2]], np.float32)
    valid = np.array([[1, 1, 1, 1, 1, 1, 1, 0]], bool)
    jv, ji, jok = jnms.topk_by_score(scores, 6, valid)
    tv, ti, tok = nms.topk_by_score(t(scores), 6, t(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


# -------------------------------------------------------------- projection


def test_projection_matches_jax_with_gradients():
    np.testing.assert_allclose(projection.get_w2cs(32), jproj.get_w2cs(32), rtol=1e-6)
    rs = np.random.RandomState(21)
    pts = rs.uniform(0, 32, (12, 3)).astype(np.float32)
    w2c = jproj.get_w2cs(32)[1]
    close(projection.project_points(t(pts), t(w2c)), jproj.project_points(pts, w2c), rtol=1e-5,
          atol=1e-3)
    wts = rs.rand(20).astype(np.float32)
    for mk in (random_obbs, random_aabbs):
        p, q = mk(20, 22), mk(20, 23)
        grads_match(lambda a, b: jproj.projection_2d_loss(a, b, wts, 32),
                    lambda a, b: projection.projection_2d_loss(a, b, t(wts), 32), p, q,
                    msg=mk.__name__)


# ------------------------------------------------------------------- eval


def _eval_inputs(mk, seed):
    rs = np.random.RandomState(seed)
    gts = [mk(5, seed + 1 + i) for i in range(3)]
    props = [np.concatenate([g + rs.randn(*g.shape).astype(np.float32) * 0.5,
                             mk(20, seed + 10 + i)]) for i, g in enumerate(gts)]
    for p in props:
        if p.shape[1] == 7:
            p[:, 3:6] = np.abs(p[:, 3:6])
    return props, [rs.rand(len(p)).astype(np.float32) for p in props], gts


def test_eval_suite_matches_jax():
    """AABB: the whole suite; OBB (the rotated IoU on the CPU): AP at the
    three thresholds. (JAX's OBB recall and precision write into the
    read-only numpy view of a jax.Array and raise; the port's IoU matrix is
    a writable array, so its recall runs: its values are pinned by the
    golden test of recall and by the AABB case here.)"""
    props, scores, gts = _eval_inputs(random_aabbs, 24)
    want = jeval.detection_eval_summary(props, scores, gts, top_n=(10, 25))
    got = teval.detection_eval_summary(props, scores, gts, top_n=(10, 25))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    pw = jeval.proposal_precision(props, scores, gts, score_thresh=0.3)
    pg = teval.proposal_precision(props, scores, gts, score_thresh=0.3)
    np.testing.assert_allclose(pg["precisions"], pw["precisions"], atol=1e-6)

    props, scores, gts = _eval_inputs(random_obbs, 40)
    for th in (0.25, 0.5, 0.75):
        want = jeval.proposal_average_precision(props, scores, gts, iou_thresh=th)
        got = teval.proposal_average_precision(props, scores, gts, iou_thresh=th)
        np.testing.assert_allclose(got["ap"], want["ap"], atol=1e-6, err_msg=str(th))
    assert 0 < teval.proposal_recall(props, scores, gts)["ar"] <= 1
    assert teval.detection_eval_summary(props, scores, gts, top_n=(10,))["ap25"] > 0


# ------------------------------------------------- golden_det.npz, directly


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIX))


def test_golden_rotated_iou_family(fx):
    b1, b2 = t(fx["iou_b1"]), t(fx["iou_b2"])
    close(rotated_iou.iou_3d(b1, b2), fx["iou"], rtol=1e-4, atol=1e-5)
    close(rotated_iou.giou_3d_loss(b1, b2, "smallest"), fx["giou_loss"], rtol=1e-4, atol=1e-4)
    close(rotated_iou.giou_3d_loss(b1, b2, "aligned"), fx["giou_loss_aligned"], rtol=1e-4,
          atol=1e-5)
    close(rotated_iou.diou_3d_loss(b1, b2, "smallest"), fx["diou_loss"], rtol=1e-4, atol=1e-4)


def test_golden_pairwise_matrices(fx):
    close(boxes.box_iou_aabb(t(fx["aabb_m1"]), t(fx["aabb_m2"])), fx["aabb_iou_matrix"],
          rtol=1e-5, atol=1e-6)
    close(rotated_iou.box_iou_obb_pairwise(t(fx["obb_m1"]), t(fx["obb_m2"])),
          fx["obb_iou_matrix"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("th", [25, 50])
def test_golden_nms(fx, th):
    keep = nms.nms_mask(t(fx["nms_boxes"]), t(fx["nms_scores"]), th / 100).numpy()
    ours = np.nonzero(keep)[0]
    ours = ours[np.argsort(-fx["nms_scores"][ours])]  # pick order
    np.testing.assert_array_equal(ours, fx[f"nms_keep_{th}"])


def test_golden_eval_suite(fx):
    ins = ([fx[f"eval_props_{i}"] for i in range(4)], [fx[f"eval_scores_{i}"] for i in range(4)],
           [fx[f"eval_gt_{i}"] for i in range(4)])
    got = teval.proposal_recall(*ins, limit=30)
    np.testing.assert_allclose(got["recalls"], fx["eval_recalls"], atol=1e-6)
    np.testing.assert_allclose(got["ar"], fx["eval_ar"], atol=1e-6)
    assert got["num_pos"] == int(fx["eval_num_pos"])
    for th in (25, 50):
        ap = teval.proposal_average_precision(*ins, iou_thresh=th / 100)["ap"]
        np.testing.assert_allclose(ap, fx[f"eval_ap_{th}"], atol=1e-6)
    prec = teval.proposal_precision(*ins, score_thresh=0.5)
    np.testing.assert_allclose(prec["precisions"], fx["eval_precisions"], atol=1e-6)
    assert prec["num_det"] == int(fx["eval_num_det"])


def _golden_gt(fx, use_obb):
    if use_obb:
        gt0, gt1 = fx["floss_gt_obb_0"], fx["floss_gt_obb_1"]
    else:
        gt0, gt1 = fx["fcos_gt_0"], fx["fcos_gt_1"]
    g, d = max(len(gt0), len(gt1)), gt0.shape[1]
    gt_boxes = np.zeros((2, g, d), np.float32)
    gt_valid = np.zeros((2, g), bool)
    gt_boxes[0, : len(gt0)], gt_valid[0, : len(gt0)] = gt0, True
    gt_boxes[1, : len(gt1)], gt_valid[1, : len(gt1)] = gt1, True
    return t(gt_boxes), t(gt_valid)


def test_golden_fcos_targets(fx):
    per_level, locs, strides, ranges = fcos_targets.level_locations((32,) * 3, (4, 8, 16, 32))
    gt, valid = _golden_gt(fx, False)
    labels, reg = fcos_targets.assign_fcos_targets(t(locs), t(strides), t(ranges), gt, valid,
                                                   center_sampling_radius=1.5, use_obb=False)
    labels, reg = labels.numpy(), reg.numpy()
    off = 0
    for lv, pl in enumerate(per_level):
        sl = slice(off, off + len(pl))
        np.testing.assert_array_equal(labels[:, sl], fx[f"fcos_labels_l{lv}"])
        np.testing.assert_allclose(reg[:, sl] / (4, 8, 16, 32)[lv], fx[f"fcos_reg_l{lv}"],
                                   rtol=1e-5, atol=1e-5, err_msg=f"reg level {lv}")
        off += len(pl)
    pos = fx["fcos_pos_l0_s1"].astype(bool)
    n0 = len(per_level[0])
    close(fcos_targets.centerness_targets(t(reg[1, :n0][pos] / 4.0)),
          fx["fcos_centerness_l0_s1"], rtol=1e-5, atol=1e-6)


def _golden_heads(fx, mode):
    return ([t(fx[f"floss_{mode}_{k}_l{lv}"]) for lv in range(4)] for k in ("cls", "reg", "ctr"))


@pytest.mark.parametrize("mode,use_obb", [("aabb", False), ("obb", True)])
def test_golden_fcos_loss(fx, mode, use_obb):
    cfg = FCOSConfig(resolution=32, use_obb=use_obb, iou_loss_type="iou",
                     norm_reg_targets=True, center_sampling_radius=1.5)
    gt, valid = _golden_gt(fx, use_obb)
    _, aux = fcos_loss(cfg, *_golden_heads(fx, mode), gt, valid, t(fx["floss_sizes"]))
    for k, key in (("loss_cls", "cls"), ("loss_reg", "reg"), ("loss_centerness", "ctr")):
        np.testing.assert_allclose(float(aux[k]), fx[f"floss_{mode}_{key}"], rtol=2e-4)


def test_golden_proj2d_component(fx):
    """The projection term of the OBB reg loss: the reference's rig and
    divisor are 160, the fixture's rig 32, so ours is the reference's x 160/32
    (as tests/test_parity_golden_det.py states)."""
    gt, valid = _golden_gt(fx, True)

    def reg_at(weight):
        cfg = FCOSConfig(resolution=32, use_obb=True, iou_loss_type="iou",
                         norm_reg_targets=True, proj2d_loss_weight=weight)
        _, aux = fcos_loss(cfg, *_golden_heads(fx, "obb"), gt, valid, t(fx["floss_sizes"]))
        return float(aux["loss_reg"])

    ref_comp = float(fx["floss_obb_reg_proj"]) - float(fx["floss_obb_reg"])
    np.testing.assert_allclose(reg_at(0.7) - reg_at(0.0), ref_comp * 160.0 / 32.0, rtol=1e-3)
    w2cs = projection.get_w2cs(32)
    np.testing.assert_allclose(w2cs, fx["proj_w2cs"], rtol=1e-5, atol=1e-5)
    for v in range(4):
        close(projection.project_points(t(fx["proj_points"]), t(w2cs[v])), fx["proj_pixels"][v],
              rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("mode,use_obb", [("aabb", False), ("obb", True)])
def test_golden_fcos_postprocess(fx, mode, use_obb):
    cfg = FCOSConfig(resolution=32, use_obb=use_obb, norm_reg_targets=True,
                     pre_nms_thresh=0.2, pre_nms_top_n=50, nms_thresh=0.3, post_nms_top_n=30,
                     min_size=0.0)
    out = fcos_postprocess(cfg, *_golden_heads(fx, mode), t(fx["floss_sizes"]))
    out = {k: v.numpy() for k, v in out.items()}
    for i in range(2):
        want = fx[f"pp_{mode}_boxes_{i}"]  # [K, 1 + 6|7], score-descending
        n = out["valid"][i].sum()
        assert n == len(want), (n, len(want))
        got_b = out["boxes"][i][:n]
        if not use_obb:  # ours carries (centre, size, 0), the reference corners
            got_b = np.concatenate([got_b[:, :3] - got_b[:, 3:6] / 2,
                                    got_b[:, :3] + got_b[:, 3:6] / 2], axis=-1)
        np.testing.assert_allclose(out["scores"][i][:n], fx[f"pp_{mode}_scores_{i}"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(out["levels"][i][:n], want[:, 0])
        np.testing.assert_allclose(got_b[:, :want.shape[1] - 1], want[:, 1:], rtol=1e-4,
                                   atol=1e-4)
