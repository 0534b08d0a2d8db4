"""Plain float32 FCOS 3D detection over a Swin-FPN with oriented boxes (the
benchmark's reference; torch and numpy only).

NeRF-MAE's FCOS finetuning (arXiv 2404.01300; reference code
nerf_rpn/model/fcos/fcos.py:26-474 and fcos/loss.py:174-591): the Swin trunk
(swin.py), an FPN (1x1 laterals, nearest top-down adds, 3^3 smoothing),
shared towers of 3^3 conv -> GroupNorm(32, eps 1e-6) -> ReLU, the
classification, box (6 distances + 2 midpoint offsets, distances through
ReLU, a learned scale per level) and centerness convs; targets by center
sampling and per-level size ranges, the smallest-volume box winning; focal
classification loss, rotated-IoU box loss weighted by centerness,
centerness BCE. The detection geometry (box decoding, the rotated
intersection polygon) is a frozen copy of the system's formulation, so both
sides measure the same polygon.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import swin
from .swin import Numerics, Params

INF = 1e8
SIZE_RANGES = ((-1.0, 16.0), (16.0, 32.0), (32.0, 64.0), (64.0, INF))


def shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    out = swin.trunk_shapes(cfg, "body.patch_partition.", "body.stages.")
    f = cfg["fpn_channels"]
    for i, c in enumerate(swin.stage_dims(cfg)):
        out[f"body.fpn.lateral{i}.weight"] = (f, c, 1, 1, 1)
        out[f"body.fpn.lateral{i}.bias"] = (f,)
        out[f"body.fpn.smooth{i}.weight"] = (f, f, 3, 3, 3)
        out[f"body.fpn.smooth{i}.bias"] = (f,)
    for i in range(cfg["num_convs"]):
        for tower in ("cls", "box"):
            out[f"head.{tower}_tower{i}.weight"] = (f, f, 3, 3, 3)
            out[f"head.{tower}_tower{i}.bias"] = (f,)
            out[f"head.{tower}_gn{i}.weight"] = (f,)
            out[f"head.{tower}_gn{i}.bias"] = (f,)
    for name, n in (("cls_logits", 1), ("bbox_pred", cfg["reg_dim"]), ("centerness", 1)):
        out[f"head.{name}.weight"] = (n, f, 3, 3, 3)
        out[f"head.{name}.bias"] = (n,)
    out["head.scales"] = (len(cfg["strides"]),)
    return out


def conv(x, p, name, num: Numerics):
    w = p[name + ".weight"]
    return num.conv3d(x.permute(0, 4, 1, 2, 3), w, p[name + ".bias"],
                      padding=w.shape[-1] // 2).permute(0, 2, 3, 4, 1)


def group_norm(x, w, b, groups: int, eps: float = 1e-6):
    n, c = x.shape[0], x.shape[-1]
    g = x.reshape(n, -1, groups, c // groups)
    mu = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    y = (g - mu) / torch.sqrt(var + eps)
    return y.reshape(x.shape) * w + b


def fpn(feats: List[torch.Tensor], p: Params, num: Numerics) -> List[torch.Tensor]:
    lat = [conv(f, p, f"body.fpn.lateral{i}", num) for i, f in enumerate(feats)]
    for i in range(len(lat) - 1, 0, -1):
        k = lat[i - 1].shape[1] // lat[i].shape[1]
        up = lat[i].repeat_interleave(k, 1).repeat_interleave(k, 2).repeat_interleave(k, 3)
        lat[i - 1] = lat[i - 1] + up
    return [conv(x, p, f"body.fpn.smooth{i}", num) for i, x in enumerate(lat)]


def head(levels: List[torch.Tensor], p: Params, cfg: dict, num: Numerics):
    logits, reg, ctr = [], [], []
    for lvl, x in enumerate(levels):
        towers = {}
        for tower in ("cls", "box"):
            h = x
            for i in range(cfg["num_convs"]):
                h = conv(h, p, f"head.{tower}_tower{i}", num)
                h = F.relu(group_norm(h, p[f"head.{tower}_gn{i}.weight"],
                                      p[f"head.{tower}_gn{i}.bias"], 32))
            towers[tower] = h
        logits.append(conv(towers["cls"], p, "head.cls_logits", num))
        ctr.append(conv(towers["box"], p, "head.centerness", num))
        r = conv(towers["box"], p, "head.bbox_pred", num) * p["head.scales"][lvl]
        reg.append(torch.cat([F.relu(r[..., :6]), r[..., 6:]], -1))
    return logits, reg, ctr


def forward(p: Params, grids: torch.Tensor, cfg: dict, keeps, num: Numerics):
    x = swin.embed(grids, p, "body.patch_partition.", cfg, num)
    return head(fpn(swin.encoder(x, p, "body.stages.", cfg, keeps, num), p, num), p, cfg, num)


# -- targets (no gradient) ----------------------------------------------------

def locations(resolution: int, strides, device):
    """(locations [L, 3] voxel centres s * i + s // 2 of every level,
    strides [L], size ranges [L, 2])."""
    locs, st, ranges = [], [], []
    for lvl, s in enumerate(strides):
        ax = np.arange(math.ceil(resolution / s), dtype=np.float32) * s + s // 2
        g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
        locs.append(g)
        st.append(np.full(len(g), s, np.float32))
        ranges.append(np.tile(np.array(SIZE_RANGES[min(lvl, 3)], np.float32), (len(g), 1)))
    to = lambda a: torch.from_numpy(np.concatenate(a)).to(device)
    return to(locs), to(st), to(ranges)


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] (x, y, z, w, l, h, theta) -> footprint corners [..., 4, 2]."""
    x, y, w, l, t = (boxes[..., i] for i in (0, 1, 3, 4, 6))
    dx = torch.stack([w / 2, -w / 2, -w / 2, w / 2], -1)
    dy = torch.stack([l / 2, l / 2, -l / 2, -l / 2], -1)
    c, s = torch.cos(t)[..., None], torch.sin(t)[..., None]
    return torch.stack([dx * c - dy * s + x[..., None], dx * s + dy * c + y[..., None]], -1)


def footprint_aabb(boxes):
    c = box_corners(boxes)
    return torch.stack([c[..., 0].amin(-1), c[..., 1].amin(-1), boxes[..., 2] - boxes[..., 5] / 2,
                        c[..., 0].amax(-1), c[..., 1].amax(-1), boxes[..., 2] + boxes[..., 5] / 2],
                       -1)


def midpoint_offsets(boxes):
    """(alpha, beta): the footprint corner on its AABB's top edge and the one
    on its right edge, from the centre, as fractions of the AABB's extent."""
    c = box_corners(boxes)
    xs, ys = c[..., 0], c[..., 1]
    xmax, xmin, ymax, ymin = xs.amax(-1), xs.amin(-1), ys.amax(-1), ys.amin(-1)
    vx = torch.where(ymax[..., None] - ys > 0.1, torch.full_like(xs, -1e6), xs).amax(-1)
    vy = torch.where(xmax[..., None] - xs > 0.1, torch.full_like(ys, 1e6), ys).amin(-1)
    near = torch.isclose(vx, xmax) & torch.isclose(vy, ymin)
    vx, vy = torch.where(near, xmax, vx), torch.where(near, ymin, vy)
    return torch.stack([(vx - boxes[..., 0]) / torch.clamp(xmax - xmin, min=1e-7),
                        (vy - boxes[..., 1]) / torch.clamp(ymax - ymin, min=1e-7)], -1)


@torch.no_grad()
def targets(gt: torch.Tensor, valid: torch.Tensor, cfg: dict):
    """(labels [B, L], reg targets [B, L, 8] with the distances divided by
    the stride) of padded OBBs gt [B, G, 7]."""
    locs, st, ranges = locations(cfg["resolution"], cfg["strides"], gt.device)
    aabb = footprint_aabb(gt)  # [B, G, 6]
    loc = locs[None, :, None, :]  # [1, L, 1, 3]
    lo, hi = aabb[:, None, :, :3], aabb[:, None, :, 3:]
    dist = torch.cat([loc - lo, hi - loc], -1)  # [B, L, G, 6]
    max_off = dist.amax(-1)
    centre = (lo + hi) / 2
    r = (st * cfg["center_sampling_radius"])[None, :, None, None]
    inside = ((loc - torch.maximum(centre - r, lo) > 0)
              & (torch.minimum(centre + r, hi) - loc > 0)).all(-1)
    in_level = (max_off >= ranges[None, :, None, 0]) & (max_off <= ranges[None, :, None, 1])
    whd = aabb[..., 3:] - aabb[..., :3]
    vol = (whd[..., 0] * whd[..., 1] * whd[..., 2])[:, None, :].expand(-1, len(locs), -1)
    cost = torch.where(inside & in_level & valid[:, None, :], vol, torch.full_like(vol, INF))
    best = cost.argmin(-1)
    labels = (cost.gather(-1, best[..., None])[..., 0] < INF).float()
    chosen = aabb.gather(1, best[..., None].expand(-1, -1, 6))
    reg = torch.cat([locs[None] - chosen[..., :3], chosen[..., 3:] - locs[None]], -1)
    mid = midpoint_offsets(gt).gather(1, best[..., None].expand(-1, -1, 2))
    return labels, torch.cat([reg / st[None, :, None], mid], -1), locs


def centerness(reg: torch.Tensor) -> torch.Tensor:
    r = lambda a, b: torch.minimum(reg[..., a], reg[..., b]) / torch.clamp(
        torch.maximum(reg[..., a], reg[..., b]), min=1e-9)
    return torch.sqrt(torch.clamp(r(0, 3) * r(1, 4) * r(2, 5), min=0.0))


# -- rotated IoU (the system's branch-free polygon, frozen) ---------------------

def _norm(v):
    return torch.sqrt((v * v).sum(-1) + 1e-12)


def decode(off: torch.Tensor) -> torch.Tensor:
    """8 offsets at the origin -> OBB [..., 7]."""
    x0, y0, z0 = -off[..., 0], -off[..., 1], -off[..., 2]
    x1, y1, z1 = off[..., 3], off[..., 4], off[..., 5]
    vx = torch.minimum(torch.maximum((x1 + x0) / 2 + off[..., 6] * (x1 - x0), x0), x1)
    vy = torch.minimum(torch.maximum((y1 + y0) / 2 + off[..., 7] * (y1 - y0), y0), y1)
    cx, cy, cz = (x0 + x1) / 2, (y0 + y1) / 2, (z0 + z1) / 2
    v0 = torch.stack([vx - cx, y1 - cy], -1)
    v1 = torch.stack([x1 - cx, vy - cy], -1)
    d0, d1 = _norm(v0), _norm(v1)
    dmax = torch.maximum(d0, d1)
    v0 = v0 / (d0[..., None] + 1e-7) * dmax[..., None]
    v1 = v1 / (d1[..., None] + 1e-7) * dmax[..., None]
    mid = (v0 + v1) / 2
    degenerate = (mid[..., 0].abs() < 1e-9) & (mid[..., 1].abs() < 1e-9)
    mx = torch.where(degenerate, torch.full_like(mid[..., 0], 1e-7), mid[..., 0])
    my = torch.where(degenerate, torch.zeros_like(mid[..., 1]), mid[..., 1])
    return torch.stack([cx, cy, cz, _norm(mid) * 2, _norm(v0 - v1), z1 - z0,
                        torch.atan2(my, mx)], -1)


def _edge_points(c1, c2):
    q1, q2 = torch.roll(c1, -1, -2), torch.roll(c2, -1, -2)
    x1, y1 = c1[..., :, None, 0], c1[..., :, None, 1]
    x2, y2 = q1[..., :, None, 0], q1[..., :, None, 1]
    x3, y3 = c2[..., None, :, 0], c2[..., None, :, 1]
    x4, y4 = q2[..., None, :, 0], q2[..., None, :, 1]
    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    den_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    den_u = (x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)
    with torch.no_grad():
        safe = torch.where(num == 0.0, torch.ones_like(num), num)
        t, u = den_t / safe, -den_u / safe
        ok = (num != 0.0) & (t > 0) & (t < 1) & (u > 0) & (u < 1)
    ts = den_t / (num + 1e-8)
    pts = torch.stack([x1 + ts * (x2 - x1), y1 + ts * (y2 - y1)], -1) * ok[..., None]
    return pts.reshape(pts.shape[:-3] + (16, 2)), ok.reshape(ok.shape[:-2] + (16,))


def _inside(pts, box):
    a = box[..., 0:1, :]
    ab, ad, am = box[..., 1:2, :] - a, box[..., 3:4, :] - a, pts - a
    pab, pad = (ab * am).sum(-1) / (ab * ab).sum(-1), (ad * am).sum(-1) / (ad * ad).sum(-1)
    return (pab > -1e-6) & (pab < 1 + 1e-6) & (pad > -1e-6) & (pad < 1 + 1e-6)


def intersection_area(c1, c2):
    pts, ok = _edge_points(c1, c2)
    with torch.no_grad():
        in12, in21 = _inside(c1, c2), _inside(c2, c1)
    verts = torch.cat([c1, c2, pts], -2)
    valid = torch.cat([in12, in21, ok], -1)
    n = valid.sum(-1, keepdim=True)
    mean = (verts * valid[..., None].float()).sum(-2, keepdim=True) / torch.clamp(
        n[..., None], min=1)
    centred = verts - mean
    with torch.no_grad():
        ang = torch.atan2(centred[..., 1], centred[..., 0])
        order = torch.argsort(torch.where(valid, ang, torch.full_like(ang, float("inf"))),
                              dim=-1, stable=True)
        sorted_ok = valid.gather(-1, order)
    s = centred.gather(-2, order[..., None].expand(centred.shape))
    poly = torch.where(sorted_ok[..., None], s, s[..., 0:1, :])
    nxt = torch.roll(poly, -1, -2)
    area = (poly[..., 0] * nxt[..., 1] - poly[..., 1] * nxt[..., 0]).sum(-1).abs() / 2
    return torch.where(n[..., 0] > 2, area, torch.zeros_like(area))


def iou_and_union(b1, b2):
    inter2d = intersection_area(box_corners(b1), box_corners(b2))
    dz = torch.clamp(torch.minimum(b1[..., 2] + b1[..., 5] / 2, b2[..., 2] + b2[..., 5] / 2)
                     - torch.maximum(b1[..., 2] - b1[..., 5] / 2, b2[..., 2] - b2[..., 5] / 2),
                     min=0.0)
    inter = inter2d * dz
    vol = lambda b: b[..., 3] * b[..., 4] * b[..., 5]
    union = vol(b1) + vol(b2) - inter
    return inter / torch.clamp(union, min=1e-8), union


# -- the loss ------------------------------------------------------------------

def sigmoid_ce(x, y):
    return torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))


def focal(x, y, alpha=0.25, gamma=2.0):
    p = torch.sigmoid(x)
    pt = p * y + (1 - p) * (1 - y)
    return sigmoid_ce(x, y) * (1 - pt) ** gamma * (alpha * y + (1 - alpha) * (1 - y))


def batch_targets(batch: Dict[str, torch.Tensor], cfg: dict):
    """Targets of the whole batch and its two normalizers (positives, and
    the centerness sum over positives)."""
    labels, reg_t, locs = targets(batch["gt_boxes"].float(), batch["gt_valid"].bool(), cfg)
    pad = (locs[None] < batch["sizes"][:, None, :]).all(-1).float()
    pos = labels * pad
    ctr_t = centerness(reg_t)
    return {"labels": labels, "reg": reg_t, "pad": pad, "pos": pos, "ctr": ctr_t,
            "n_pos": max(float(pos.sum()), 1.0), "n_ctr": max(float((ctr_t * pos).sum()), 1e-6)}


def loss(logits, reg, ctr, t: dict, rows: slice, cfg: dict) -> Dict[str, torch.Tensor]:
    """The rows' share of the batch's loss terms: their sums over the
    batch's normalizers."""
    flat = lambda xs, d: torch.cat([x.reshape(x.shape[0], -1, d) for x in xs], 1)
    cls_f, reg_f, ctr_f = flat(logits, 1)[..., 0], flat(reg, cfg["reg_dim"]), flat(ctr, 1)[..., 0]
    labels, pad, pos, ctr_t, reg_t = (t[k][rows] for k in ("labels", "pad", "pos", "ctr", "reg"))
    cls_loss = (focal(cls_f, labels) * pad).sum() / t["n_pos"]
    posm = pos[..., None] > 0
    safe = torch.tensor([1.0] * 6 + [0.2] * 2, device=reg_f.device)
    iou, union = iou_and_union(decode(torch.where(posm, reg_f, safe)),
                               decode(torch.where(posm, reg_t, safe)))
    per_loc = -torch.log(torch.clamp((iou * union + 1.0) / (union + 1.0), min=1e-7))
    reg_loss = (per_loc * ctr_t * pos).sum() / t["n_ctr"]
    ctr_loss = (sigmoid_ce(ctr_f, ctr_t) * pos).sum() / t["n_pos"]
    return {"loss_cls": cls_loss, "loss_reg": reg_loss, "loss_centerness": ctr_loss}


def loss_and_grads(p: Params, batch, keeps, cfg: dict, num: Numerics, rows_per_pass: int):
    b = batch["grids"].shape[0]
    t = batch_targets(batch, cfg)
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total, sums = 0.0, {}
    for s in range(0, b, rows_per_pass):
        rows = slice(s, s + rows_per_pass)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        out = forward(leaves, batch["grids"][rows], cfg, swin.rows_of(keeps, rows), num)
        terms = loss(*out, t, rows, cfg)
        for k, v in terms.items():
            sums[k] = sums.get(k, 0.0) + float(v.detach())
        value = (terms["loss_cls"] + cfg["reg_loss_weight"] * terms["loss_reg"]
                 + terms["loss_centerness"])
        names = list(leaves)
        for k, g in zip(names, torch.autograd.grad(value, [leaves[k] for k in names],
                                                   allow_unused=True)):
            if g is not None:
                grads[k] += g
        total += float(value.detach())
        del out, value, terms, leaves
    return total, grads, sums
