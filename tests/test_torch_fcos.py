"""The port's detection models against the JAX package, on the CPU.

GroupNorm (flax's epsilon 1e-6, float32 statistics and output for a bf16
input), the SAME-padded strided convolutions, FPN3D (with and without its
extra levels), the three backbones (SwinFPN, ResNetFPN, VGGFPN), FCOSHead
(AABB and OBB), fcos_loss for every IoU type with the additional L1 and 2D
projection terms (values and gradients w.r.t. the head outputs),
fcos_postprocess (AABB and OBB), and the whole FCOSDetector in training and
prediction through det_params_from_jax. Tiny config: swin_nano (embed 12),
32^3 grids, FPN width 32 (the detector's own test: 256 is the trainer's
width), float32, stochastic depth 0. Tolerances: outputs rtol 2e-3 / atol
2e-4 (tests/test_parity_golden.py), losses rtol 1e-3, exact for
selections.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.config import SWIN_PRESETS as JPRESETS
from nerf_mae_tpu.models import backbones as jbackbones
from nerf_mae_tpu.models import fcos as jfcos
from nerf_mae_tpu.models.detector import FCOSDetector as JDetector
from nerf_mae_tpu.models.fpn import FPN3D as JFPN3D
from nerf_mae_torch.config import SWIN_PRESETS
from nerf_mae_torch.convert import det_params_from_jax, flatten_tree
from nerf_mae_torch.models import fcos as tfcos
from nerf_mae_torch.models.detector import FCOSDetector
from nerf_mae_torch.models.fpn import FPN3D
from nerf_mae_torch.models.unetr import Conv3d, group_norm

from test_torch_heads import fill_params

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 2e-4
LOSS_RTOL = 1e-3
WIDTH = 32


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


def _init_shapes(module, *args, **kw):
    return jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)}, *args, **kw)
        ["params"])


def _params(module, *args, seed=0, **kw):
    params = fill_params(_init_shapes(module, *args, **kw), seed)
    if "head" in params or "scales" in params:  # per-level scales near 1
        head = params.get("head", params)
        head["scales"] = (1.0 + 0.1 * np.random.RandomState(seed).randn(4)).astype(np.float32)
    return params


def _sd(params, prefix=""):
    """A flax subtree -> the port's names: kernel -> weight (OIDHW), scale ->
    weight, "/" -> "."."""
    out = {}
    for k, v in flatten_tree(params).items():
        parts = k.split("/")
        leaf = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
        v = np.asarray(v)
        if parts[-1] == "kernel":
            v = np.transpose(v, (4, 3, 0, 1, 2))
        out[prefix + ".".join(parts[:-1] + [leaf])] = t(v)
    return out


def _feats(seed, widths, sizes=(8, 4, 2, 1), b=2):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, s, s, c).astype(np.float32) for s, c in zip(sizes, widths)]


def _grids(b=2, seed=0):
    rs = np.random.RandomState(seed)
    g = rs.rand(b, 32, 32, 32, 4).astype(np.float32)
    g[..., 3] *= rs.rand(b, 32, 32, 32) > 0.5
    return g


# ------------------------------------------------------- norms and convs


def test_group_norm_is_flax_groupnorm():
    """epsilon 1e-6 (a group variance of ~1e-6 makes 1e-5 visibly wrong),
    float32 statistics, a float32 result for a bf16 input."""
    rs = np.random.RandomState(0)
    x = (1.0 + 1e-3 * rs.randn(2, 4, 4, 4, 64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    scale = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    bias = (0.1 * rs.randn(64)).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=32)
    want = gn.apply({"params": {"scale": scale, "bias": bias}}, xb)
    got = group_norm(t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16), t(scale),
                     t(bias), 32)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    close(got, want, rtol=1e-4, atol=1e-4)
    loose = torch.nn.functional.group_norm(
        got.new_tensor(np.asarray(xb.astype(jnp.float32))).permute(0, 4, 1, 2, 3), 32,
        t(scale), t(bias), eps=1e-5).permute(0, 2, 3, 4, 1)
    assert (loose - got).abs().max() > 1e-2  # torch's epsilon would not do


@pytest.mark.parametrize("k,stride,n", [(3, 2, 8), (3, 2, 7), (7, 4, 32), (1, 2, 9)])
def test_strided_conv_pads_like_flax_same(k, stride, n):
    rs = np.random.RandomState(1)
    x = rs.randn(1, n, n, n, 3).astype(np.float32)
    conv = fnn.Conv(5, (k,) * 3, strides=(stride,) * 3, padding="SAME")
    params = fill_params(jax.eval_shape(lambda: conv.init(jax.random.PRNGKey(0), x))["params"], 2)
    want = conv.apply({"params": params}, x)
    mod = Conv3d(3, 5, k)
    mod.load_state_dict(_sd(params))
    close(mod(t(x), torch.float32, stride=stride), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ FPN


@pytest.mark.parametrize("extra_convs", [False, True])
def test_fpn_matches_jax(extra_convs):
    widths = (12, 24, 48)
    feats = _feats(3, widths, sizes=(8, 4, 2))
    jm = JFPN3D(out_channels=WIDTH, num_outs=5, extra_convs=extra_convs, dtype=jnp.float32)
    params = fill_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), feats))["params"],
                         4)
    want = jm.apply({"params": params}, feats)
    tm = FPN3D(widths, WIDTH, num_outs=5, extra_convs=extra_convs, dtype=torch.float32,
               device="cpu")
    tm.load_state_dict(_sd(params))
    got = tm([t(f) for f in feats])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, msg=f"level {i}")


# ------------------------------------------------------------- backbones


def _jax_body(backbone):
    if backbone.startswith("swin"):
        return jbackbones.SwinFPN(swin=JPRESETS[backbone], out_channels=WIDTH,
                                  dtype=jnp.float32, remat=False)
    if backbone == "resnet":
        return jbackbones.ResNetFPN(out_channels=WIDTH, dtype=jnp.float32)
    return jbackbones.VGGFPN(config=backbone.split("_")[1], out_channels=WIDTH,
                             dtype=jnp.float32)


@pytest.mark.parametrize("backbone", ["swin_nano", "resnet", "vgg_AF"])
def test_backbones_match_jax(backbone):
    grids = _grids()
    jm = _jax_body(backbone)
    jdet = JDetector(swin=JPRESETS["swin_nano"], fcos=jfcos.FCOSConfig(resolution=32),
                     backbone=backbone, out_channels=WIDTH, dtype=jnp.float32, remat=False)
    params = fill_params(_init_shapes(jm, grids[:1], True), 5)
    want = jm.apply({"params": params}, grids, True)
    det = FCOSDetector(SWIN_PRESETS["swin_nano"], tfcos.FCOSConfig(resolution=32), backbone,
                       WIDTH, dtype=torch.float32, remat=False, device="cpu")
    sd = det_params_from_jax({"body": params, "head": _params(
        jdet, grids[:1], np.full((1, 3), 32), np.zeros((1, 4, 6)), np.zeros((1, 4), bool),
        True, True)["head"]}, SWIN_PRESETS["swin_nano"], tfcos.FCOSConfig(resolution=32),
        backbone, WIDTH)
    det.load_state_dict(sd)
    got = det.body(t(grids))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, msg=f"{backbone} level {i}")


# ------------------------------------------------------------------- head


def _head_io(use_obb, seed=6):
    cfg = jfcos.FCOSConfig(resolution=32, use_obb=use_obb)
    feats = _feats(seed, (WIDTH,) * 4)
    jm = jfcos.FCOSHead(cfg=cfg, in_channels=WIDTH, dtype=jnp.float32)
    params = _params(jm, feats, seed=seed)
    return cfg, feats, jm, params


@pytest.mark.parametrize("use_obb", [False, True])
def test_fcos_head_matches_jax(use_obb):
    cfg, feats, jm, params = _head_io(use_obb)
    want = jm.apply({"params": params}, feats)
    head = tfcos.FCOSHead(tfcos.FCOSConfig(resolution=32, use_obb=use_obb), WIDTH,
                          dtype=torch.float32, device="cpu")
    head.load_state_dict(_sd(params))
    got = head([t(f) for f in feats])
    for name, gs, ws in zip(("logits", "bbox", "centerness"), got, want):
        for lvl, (g, w) in enumerate(zip(gs, ws)):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            close(g, w, msg=f"{name} level {lvl}")
    # in bf16 the towers still hand float32 out of every GroupNorm and head
    head_bf16 = tfcos.FCOSHead(tfcos.FCOSConfig(resolution=32, use_obb=use_obb), WIDTH,
                               dtype=torch.bfloat16, device="cpu")
    head_bf16.load_state_dict(_sd(params))
    out = head_bf16([t(f).to(torch.bfloat16) for f in feats])
    assert all(x.dtype == torch.float32 for xs in out for x in xs)
    assert (out[1][0][..., :6] >= 0).all()
    if use_obb:  # the midpoint channels stay raw
        assert (out[1][0][..., 6:] < 0).any()


@pytest.mark.parametrize("reference_init", [False, True])
def test_head_init_matches_jax(reference_init):
    cfg = tfcos.FCOSConfig(resolution=32, use_obb=True, reference_init=reference_init)
    head = tfcos.FCOSHead(cfg, WIDTH, dtype=torch.float32, device="cpu")
    head.init_weights(torch.Generator().manual_seed(0))
    bias = head.bbox_pred.bias.detach().numpy()
    np.testing.assert_array_equal(bias[:6], 0.0 if reference_init else 0.5)
    np.testing.assert_array_equal(bias[6:], 0.0)
    np.testing.assert_allclose(head.cls_logits.bias.item(), -np.log(99.0), rtol=1e-6)
    assert abs(head.cls_tower0.weight.std().item() - 0.01) < 1e-3
    np.testing.assert_array_equal(head.scales.detach().numpy(), 1.0)


# ------------------------------------------------------------------- loss


def _head_outputs(use_obb, seed):
    rs = np.random.RandomState(seed)
    d = 8 if use_obb else 6
    logits, reg, ctr = [], [], []
    for s in (8, 4, 2, 1):
        logits.append((rs.randn(2, s, s, s, 1) - 1).astype(np.float32))
        r = rs.uniform(0.2, 3.0, (2, s, s, s, d))
        if use_obb:
            r[..., 6:] = rs.uniform(-0.4, 0.4, (2, s, s, s, 2))
        reg.append(r.astype(np.float32))
        ctr.append(rs.randn(2, s, s, s, 1).astype(np.float32))
    return logits, reg, ctr


def _gt(use_obb, seed=8):
    rs = np.random.RandomState(seed)
    n = 5
    if use_obb:
        gt = np.concatenate([rs.uniform(8, 24, (2, n, 3)), rs.uniform(4, 14, (2, n, 3)),
                             rs.uniform(-1.5, 1.5, (2, n, 1))], -1)
    else:
        lo = rs.uniform(0, 20, (2, n, 3))
        gt = np.concatenate([lo, lo + rs.uniform(4, 12, (2, n, 3))], -1)
    valid = np.ones((2, n), bool)
    valid[1, -1] = False
    sizes = np.array([[32, 32, 32], [28, 30, 25]], np.int32)
    return gt.astype(np.float32), valid, sizes


LOSS_CASES = [(False, "iou"), (False, "linear_iou"), (False, "giou"), (False, "smooth_l1"),
              (True, "iou"), (True, "linear_iou"), (True, "giou"), (True, "diou"),
              (True, "smooth_l1")]


@pytest.mark.parametrize("use_obb,iou_type", LOSS_CASES)
def test_fcos_loss_matches_jax_with_gradients(use_obb, iou_type):
    extra = dict(use_additional_l1_loss=True, proj2d_loss_weight=0.5) if (
        use_obb and iou_type == "iou") else {}
    jcfg = jfcos.FCOSConfig(resolution=32, use_obb=use_obb, iou_loss_type=iou_type, **extra)
    tcfg = tfcos.FCOSConfig(resolution=32, use_obb=use_obb, iou_loss_type=iou_type, **extra)
    heads = _head_outputs(use_obb, seed=9)
    gt, valid, sizes = _gt(use_obb)

    def jloss(l, r, c):
        total, aux = jfcos.fcos_loss(jcfg, l, r, c, gt, valid, sizes)
        return total, aux

    (jtotal, jaux), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(*heads)
    tin = [[t(x).requires_grad_(True) for x in xs] for xs in heads]
    total, aux = tfcos.fcos_loss(tcfg, *tin, t(gt), t(valid), t(sizes))
    total.backward()
    assert float(aux["num_pos"]) == float(jaux["num_pos"]) > 0
    for k in ("loss_cls", "loss_reg", "loss_centerness"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=LOSS_RTOL)
    scale = max(float(np.abs(np.asarray(g)).max()) for gs in jgrads for g in gs)
    for name, ts, gs in zip(("logits", "reg", "ctr"), tin, jgrads):
        for lvl, (x, g) in enumerate(zip(ts, gs)):
            close(x.grad, g, rtol=LOSS_RTOL, atol=1e-4 * scale, msg=f"d{name} level {lvl}")


# ---------------------------------------------------------- postprocess


@pytest.mark.parametrize("use_obb", [False, True])
def test_fcos_postprocess_matches_jax(use_obb):
    kw = dict(resolution=32, use_obb=use_obb, pre_nms_top_n=100, post_nms_top_n=300,
              nms_thresh=0.1, min_size=0.5)
    logits, reg, ctr = _head_outputs(use_obb, seed=10)
    ctr[0][0, :2, :2, :2] = 50.0  # saturated scores tie
    logits[0][0, :2, :2, :2] = 50.0
    _, _, sizes = _gt(use_obb)
    j = lambda xs: [jnp.asarray(x) for x in xs]
    want = jfcos.fcos_postprocess(jfcos.FCOSConfig(**kw), j(logits), j(reg), j(ctr),
                                  jnp.asarray(sizes))
    got = tfcos.fcos_postprocess(tfcos.FCOSConfig(**kw), [t(x) for x in logits],
                                 [t(x) for x in reg], [t(x) for x in ctr], t(sizes))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["levels"].numpy(), np.asarray(want["levels"]))
    close(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    close(got["boxes"], want["boxes"], rtol=1e-5, atol=1e-5)
    assert 0 < got["valid"].sum() < got["valid"].numel()


# ------------------------------------------------------------- detector


@pytest.mark.parametrize("use_obb", [False, True])
def test_detector_matches_jax_in_training_and_prediction(use_obb):
    grids = _grids(seed=11)
    gt, valid, sizes = _gt(use_obb, seed=12)
    kw = dict(resolution=32, use_obb=use_obb, pre_nms_top_n=80, post_nms_top_n=40)
    jm = JDetector(swin=JPRESETS["swin_nano"], fcos=jfcos.FCOSConfig(**kw), backbone="swin_nano",
                   out_channels=WIDTH, dtype=jnp.float32, remat=False, output_objectness=True)
    j = jnp.asarray
    params = _params(jm, j(grids[:1]), j(sizes[:1]), j(gt[:1]), j(valid[:1]), True, True,
                     seed=13)
    jtotal, jaux = jm.apply({"params": params}, j(grids), j(sizes), j(gt), j(valid), True, True)
    jdet = jm.apply({"params": params}, j(grids), j(sizes))

    model = FCOSDetector(SWIN_PRESETS["swin_nano"], tfcos.FCOSConfig(**kw), "swin_nano", WIDTH,
                         dtype=torch.float32, remat=False, output_objectness=True, device="cpu")
    model.load_state_dict(det_params_from_jax(params, SWIN_PRESETS["swin_nano"],
                                              tfcos.FCOSConfig(**kw), "swin_nano", WIDTH))
    total, aux = model(t(grids), t(sizes), t(gt), t(valid), deterministic=True, training=True)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=LOSS_RTOL)
    for k in ("loss_cls", "loss_reg", "loss_centerness", "num_pos"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=LOSS_RTOL, err_msg=k)
    with torch.no_grad():
        det = model(t(grids), t(sizes))
    assert set(det) == set(jdet)
    n = int(det["valid"].sum())
    np.testing.assert_array_equal(det["valid"].numpy(), np.asarray(jdet["valid"]))
    close(det["scores"], jdet["scores"], msg="scores")
    # rows beyond a near-tied score could swap; the leading ones match
    close(det["boxes"][:, : n // 4], np.asarray(jdet["boxes"])[:, : n // 4], msg="boxes")
    for lvl in range(4):
        close(det[f"objectness_level{lvl}"], jdet[f"objectness_level{lvl}"])
