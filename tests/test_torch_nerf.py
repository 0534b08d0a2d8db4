"""The port's per-scene NeRF (nerf_mae_torch/nerf/) against the JAX package's
(nerf_mae_tpu/nerf/) on the CPU: the same inputs from a numpy seed, the same
weights (a flax tree bridged by convert.nerf_params_from_jax) and the same
draws (jax.random.uniform under the JAX functions' key splits, passed to the
port as `u`), float32, tiny MLPs (depth 3, width 48).

Tolerances: rtol 1e-4 / atol 1e-5 on the rendering functions and one
forward (float32 reductions in another order, and torch.linspace against
jnp.linspace: up to one ulp of a sample depth); one train step's losses at
rtol 1e-4 (the golden loss tolerance is 1e-3) and its Adam moments and
updated parameters at the golden rtol 2e-3 / atol 2e-4; the extracted grid
at rtol 2e-3 / atol 2e-4 (the port runs the view-independent trunk once a
point, JAX once a (point, view)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_torch.convert import nerf_params_from_jax
from nerf_mae_torch.nerf import extract as textract
from nerf_mae_torch.nerf import model as tmodel
from nerf_mae_torch.nerf import render as trender
from nerf_mae_torch.nerf.train import NeRFParams, NeRFTrainer
from nerf_mae_tpu.nerf import extract as jextract
from nerf_mae_tpu.nerf import model as jmodel
from nerf_mae_tpu.nerf import render as jrender
from nerf_mae_tpu.nerf.train import NeRFTrainer as JNeRFTrainer

torch.set_num_threads(1)

TINY = dict(depth=3, width=48, skip_at=1, pos_freqs=5, dir_freqs=2)
RENDER = dict(rtol=1e-4, atol=1e-5)
GOLDEN = dict(rtol=2e-3, atol=2e-4)


def look_at(eye, target=(0, 0, 0), up=(0, 0, 1)):
    eye = np.asarray(eye, np.float32)
    f = eye - np.asarray(target, np.float32)
    f /= np.linalg.norm(f)
    r = np.cross(np.asarray(up, np.float32), f)
    r /= np.linalg.norm(r)
    u = np.cross(f, r)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, u, f, eye
    return c2w


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def bridged(seed=0, cam_embed_dim=0, fine=False, n_views=0):
    """(JAX params {coarse, fine?, cam?}, the port's NeRFParams with them)."""
    jm = jmodel.NeRFMLP(**TINY, cam_embed_dim=cam_embed_dim)
    init = lambda k: jm.init(k, jnp.zeros((1, 1, 3)), jnp.zeros((1, 1, 3)))["params"]
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    jp = {"coarse": init(keys[0])}
    if fine:
        jp["fine"] = init(keys[1])
    if cam_embed_dim:
        rs = np.random.RandomState(seed)
        jp["cam"] = jnp.asarray(0.3 * rs.randn(n_views, cam_embed_dim).astype(np.float32))
    new = lambda: tmodel.NeRFMLP(**TINY, cam_embed_dim=cam_embed_dim)
    tp = NeRFParams(new(), new() if fine else None, n_views, cam_embed_dim)
    tp.load_state_dict(nerf_params_from_jax(jax.device_get(jp), tp))
    return jm, jp, tp


def rays(n, seed):
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * 0.3 + np.array([0.0, 0.0, 2.0])).astype(np.float32)
    d = (rs.randn(n, 3) * 0.2 + np.array([0.0, 0.0, -1.0])).astype(np.float32)
    return o, d


def jax_apply(jm):
    return lambda p, pts, vd: jm.apply({"params": p}, pts, vd)


def torch_apply(net, pts, vd):
    return net(pts, vd)


@pytest.mark.parametrize("n_freqs", [1, 4, 10])
def test_positional_encoding_matches_jax(n_freqs):
    x = np.random.RandomState(n_freqs).randn(4, 6, 3).astype(np.float32)
    got = tmodel.positional_encoding(t(x), n_freqs)
    assert got.shape == (4, 6, 6 * n_freqs)
    close(got, jmodel.positional_encoding(jnp.asarray(x), n_freqs), **RENDER)


def test_get_rays_matches_jax():
    pose = look_at((1.5, -2.0, 0.7))
    o, d = trender.get_rays(t(pose), 6, 10, 9.5)
    jo, jd = jrender.get_rays(jnp.asarray(pose), 6, 10, 9.5)
    close(o, jo, rtol=1e-6, atol=1e-6)
    close(d, jd, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cam", [False, True])
def test_nerf_mlp_matches_flax(cam):
    jm, jp, tp = bridged(cam_embed_dim=4 if cam else 0, n_views=3)
    rs = np.random.RandomState(2)
    pts = rs.randn(5, 7, 3).astype(np.float32)
    vd = rs.randn(5, 1, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    ce = rs.randn(5, 1, 4).astype(np.float32) if cam else None
    want = jax.jit(jm.apply)({"params": jp["coarse"]}, jnp.asarray(pts), jnp.asarray(vd),
                             None if ce is None else jnp.asarray(ce))
    got = tp.coarse(t(pts), t(vd), None if ce is None else t(ce))
    for g, w in zip(got, want):
        close(g, w, **RENDER)
    if cam:  # no latent: the zero latent
        want0 = jax.jit(jm.apply)({"params": jp["coarse"]}, jnp.asarray(pts), jnp.asarray(vd))
        close(tp.coarse(t(pts), t(vd))[0], want0[0], **RENDER)


def test_init_is_flax_lecun_normal():
    """Both inits draw kernels with std sqrt(1 / fan_in), truncated at two
    standard deviations of the underlying normal, and zero biases."""
    net = tmodel.NeRFMLP().reset_parameters(torch.Generator().manual_seed(0))
    for name in ("fc0", "fc5", "feat", "color_fc"):
        w = getattr(net, name).weight.detach().numpy()
        std = np.sqrt(1.0 / w.shape[1])
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
        assert abs(w.std() / std - 1) < 0.05
        assert not getattr(net, name).bias.detach().numpy().any()
    _, jp, _ = bridged()
    k = np.asarray(jp["coarse"]["fc1"]["kernel"])  # [in, out]
    std = np.sqrt(1.0 / k.shape[0])
    assert np.abs(k).max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(k.std() / std - 1) < 0.05
    assert not np.asarray(jp["coarse"]["fc1"]["bias"]).any()


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_render_rays_matches_jax(white_bkgd):
    jm, jp, tp = bridged()
    o, d = rays(24, 3)
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (24, 16)))
    want = jax.jit(lambda p, o, d, k: jrender.render_rays(
        p, jax_apply(jm), o, d, 0.5, 3.5, 16, k, white_bkgd))(jp["coarse"], o, d, key)
    got = trender.render_rays(tp.coarse, torch_apply, t(o), t(d), 0.5, 3.5, 16, None,
                              white_bkgd, u=t(u))
    for k in ("rgb", "depth", "acc", "weights", "z_vals"):
        close(got[k], want[k], **RENDER)
    # deterministic: no draws on either side
    want = jax.jit(lambda p, o, d: jrender.render_rays(p, jax_apply(jm), o, d, 0.5, 3.5, 16))(
        jp["coarse"], o, d)
    got = trender.render_rays(tp.coarse, torch_apply, t(o), t(d), 0.5, 3.5, 16)
    for k in ("rgb", "depth", "acc"):
        close(got[k], want[k], **RENDER)


@pytest.mark.parametrize("draws", [False, True])
def test_sample_pdf_matches_jax(draws):
    rs = np.random.RandomState(4)
    bins = np.sort(rs.rand(6, 13).astype(np.float32) * 3, axis=1)
    w = rs.rand(6, 12).astype(np.float32) ** 4
    w[0] = 0.0  # all-zero weights: the 1e-5 guard
    w[1, 3:] = 0.0
    key = jax.random.PRNGKey(5) if draws else None
    want = jrender.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 20, key)
    u = t(np.asarray(jax.random.uniform(key, (6, 20)))) if draws else None
    close(trender.sample_pdf(t(bins), t(w), 20, u=u), want, **RENDER)


def test_render_rays_hierarchical_matches_jax():
    jm, jp, tp = bridged(fine=True)
    o, d = rays(16, 6)
    key = jax.random.PRNGKey(11)
    kc, kf = jax.random.split(key)
    u = (t(np.asarray(jax.random.uniform(kc, (16, 12)))),
         t(np.asarray(jax.random.uniform(kf, (16, 10)))))
    want = jax.jit(lambda p, o, d, k: jrender.render_rays_hierarchical(
        p["coarse"], p["fine"], jax_apply(jm), o, d, 0.5, 3.5, 12, 10, k))(jp, o, d, key)
    got = trender.render_rays_hierarchical(tp.coarse, tp.fine, torch_apply, t(o), t(d), 0.5,
                                           3.5, 12, 10, u=u)
    for k in ("rgb", "depth", "acc", "weights", "z_vals", "rgb0", "depth0", "acc0"):
        close(got[k], want[k], **RENDER)


@pytest.mark.parametrize("draws", [False, True])
def test_sample_3sigma_matches_jax(draws):
    low = np.array([1.0, 0.0, 2.5, 0.7], np.float32)
    high = np.array([2.0, 0.5, 3.9, 0.7], np.float32)  # clamped at near; zero width
    key = jax.random.PRNGKey(3) if draws else None
    want = jrender.sample_3sigma(jnp.asarray(low), jnp.asarray(high), 16, 0.5, 4.0, key)
    u = t(np.asarray(jax.random.uniform(key, (4, 16)))) if draws else None
    close(trender.sample_3sigma(t(low), t(high), 16, 0.5, 4.0, u=u), want, **RENDER)


def test_depth_and_std_and_nll_match_jax():
    rs = np.random.RandomState(8)
    z = np.sort(rs.rand(5, 9).astype(np.float32) * 4, axis=1)
    w = rs.rand(5, 9).astype(np.float32) / 5
    target = rs.rand(5).astype(np.float32) * 4
    valid = np.array([True, False, True, True, False])
    d, s = trender.depth_and_std(t(z), t(w))
    jd, js = jrender.depth_and_std(jnp.asarray(z), jnp.asarray(w))
    close(d, jd, **RENDER)
    close(s, js, **RENDER)
    close(trender.depth_nll_loss(d, t(z), t(w), t(target), t(valid)),
          jrender.depth_nll_loss(jd, jnp.asarray(z), jnp.asarray(w), jnp.asarray(target),
                                 jnp.asarray(valid)), **RENDER)
    assert float(trender.depth_nll_loss(d, t(z), t(w), t(target), t(valid & False))) == 0.0


def test_render_rays_depth_guided_matches_jax():
    jm, jp, tp = bridged()
    o, d = rays(16, 9)
    rs = np.random.RandomState(10)
    td = (rs.rand(16) * 2 + 1).astype(np.float32)
    valid = rs.rand(16) > 0.4
    band = 0.09 * td
    key = jax.random.PRNGKey(12)
    ka, kb = jax.random.split(key)
    u = (t(np.asarray(jax.random.uniform(ka, (16, 8)))),
         t(np.asarray(jax.random.uniform(kb, (16, 8)))))
    want = jax.jit(lambda p, o, d, td, lo, hi, v, k: jrender.render_rays_depth_guided(
        p, jax_apply(jm), o, d, 0.5, 3.5, td, lo, hi, v, 16, k))(
        jp["coarse"], o, d, td, td - band, td + band, valid, key)
    got = trender.render_rays_depth_guided(
        tp.coarse, torch_apply, t(o), t(d), 0.5, 3.5, t(td), t(td - band), t(td + band),
        t(valid), 16, u=u)
    for k in ("rgb", "depth", "acc", "weights", "z_vals", "depth0", "acc0"):
        close(got[k], want[k], **RENDER)
    assert (np.diff(got["z_vals"].numpy(), axis=1) >= 0).all()


def test_no_gradient_through_the_detached_samples():
    """The fine samples (hierarchical) and the band samples (depth-guided)
    carry no gradient: a loss on the fine pass alone gives the coarse
    network nothing, and neither path's merged depths need a gradient."""
    _, _, tp = bridged(fine=True)
    o, d = rays(8, 13)
    out = trender.render_rays_hierarchical(tp.coarse, tp.fine, torch_apply, t(o), t(d), 0.5,
                                           3.5, 12, 10, torch.Generator().manual_seed(0))
    assert not out["z_vals"].requires_grad
    out["rgb"].sum().backward()
    assert all(p.grad is None for p in tp.coarse.parameters())
    assert any(p.grad is not None and p.grad.abs().sum() > 0 for p in tp.fine.parameters())

    td = torch.full((8,), 2.0)
    out = trender.render_rays_depth_guided(tp.coarse, torch_apply, t(o), t(d), 0.5, 3.5, td,
                                           td - 0.2, td + 0.2, torch.tensor([True] * 4 + [False] * 4),
                                           16, torch.Generator().manual_seed(1))
    assert not out["z_vals"].requires_grad


def _jax_draws(kind, key, n, s, imp):
    """The uniforms JAX's train step draws from `key`, in the port's u form."""
    u = lambda k, m: t(np.asarray(jax.random.uniform(k, (n, m))))
    if kind == "plain":
        return u(key, s)
    a, b = jax.random.split(key)
    return (u(a, s), u(b, imp)) if kind == "hierarchical" else (u(a, s // 2), u(b, s // 2))


@pytest.mark.parametrize("kind", ["plain", "hierarchical", "depth_guided_cam"])
def test_train_step_matches_jax(kind):
    n, s, imp, views = 64, 12, 8, 3
    cam_dim = 4 if kind == "depth_guided_cam" else 0
    kw = dict(near=0.5, far=3.5, n_samples=s, n_importance=imp if kind == "hierarchical" else 0,
              depth_guided=kind == "depth_guided_cam", depth_loss_weight=0.3 if cam_dim else 0.0,
              cam_embed_dim=cam_dim, lr=5e-4, ray_batch=n, scene_scale=1.7)
    jtr = JNeRFTrainer(**kw, model=jmodel.NeRFMLP(**TINY, cam_embed_dim=cam_dim))
    ttr = NeRFTrainer(**kw, model=tmodel.NeRFMLP(**TINY, cam_embed_dim=cam_dim), device="cpu")
    _, jp, tp = bridged(seed=1, cam_embed_dim=cam_dim, fine=kind == "hierarchical",
                        n_views=views)
    opt = torch.optim.Adam(tp.parameters(), lr=5e-4, betas=(0.9, 0.999), eps=1e-8)
    _, topt = ttr.init(0, n_views=views)  # the trainer's optimizer settings
    assert topt.defaults["betas"] == (0.9, 0.999) and topt.defaults["eps"] == 1e-8

    rs = np.random.RandomState(14)
    o, d = rays(n, 15)
    rgb = rs.rand(n, 3).astype(np.float32)
    depth = (rs.rand(n) * 2 + 1).astype(np.float32)
    valid = rs.rand(n) > 0.3
    view = rs.randint(0, views, n).astype(np.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    args = (o, d, rgb, depth, valid, view)
    jp1, jopt, jloss, jimg = jtr.train_step(jp, jtr.tx.init(jp), *map(jnp.asarray, args), key)
    tp1, opt, loss, img = ttr.train_step(tp, opt, *(t(a) for a in args[:5]), t(view).long(),
                                         u=_jax_draws(kind, key, n, s, imp))
    close(loss, jloss, rtol=1e-4)
    close(img, jimg, rtol=1e-4)
    want = nerf_params_from_jax(jax.device_get(jp1), tp1)
    mu = nerf_params_from_jax(jax.device_get(jopt[0].mu), tp1)
    for name, p in tp1.named_parameters():
        close(opt.state[p]["exp_avg"], mu[name], **GOLDEN)
        close(p, want[name], **GOLDEN)


def test_depth_guided_excludes_hierarchical():
    with pytest.raises(ValueError):
        NeRFTrainer(near=0.5, far=4.0, n_importance=8, depth_guided=True, device="cpu")


def test_extract_matches_jax():
    jm, jp, tp = bridged(seed=2)
    poses = np.stack([look_at(e) for e in [(2, 0, 0.3), (0, 2, 0), (-1.4, -1.4, 0.8)]])
    bmin, bmax = np.array([-1.0, -0.8, -0.5]), np.array([1.0, 1.0, 0.5])
    scale = 1.3
    apply = lambda p, pts, vd: jm.apply({"params": p}, pts / scale, vd)
    want = jextract.extract_rgbsigma_grid(jp["coarse"], apply, bmin, bmax, poses, max_res=12,
                                          chunk=500)
    got = textract.extract_rgbsigma_grid(tp.coarse, bmin, bmax, poses, max_res=12, chunk=500,
                                         scene_scale=scale)
    assert set(got) == set(want)
    assert got["rgbsigma"].shape == want["rgbsigma"].shape == (12, 11, 6, 4)
    assert got["rgbsigma"].dtype == np.float32
    close(got["rgbsigma"], want["rgbsigma"], **GOLDEN)
    for k in ("resolution", "bbox_min", "bbox_max"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    for k in ("scale", "offset", "from_mitsuba"):
        assert got[k] == want[k]


def analytic_field(_params, pts, viewdir):
    """A red solid sphere of radius 0.5 at the origin."""
    sigma = torch.where(torch.linalg.norm(pts, dim=-1) < 0.5, 20.0, 0.0)
    rgb = torch.tensor([4.0, -4.0, -4.0]).expand(*pts.shape[:-1], 3)
    return rgb, sigma


def test_fit_converges_on_the_analytic_sphere():
    """The port's own fit, as tests/test_nerf.py fits the JAX trainer: views
    of the sphere rendered by the port's renderer, PSNR > 14 after 250
    steps; the extracted grid holds the sphere."""
    h = w = 20
    focal = 20.0
    eyes = [(2, 0, 0), (0, 2, 0), (-2, 0, 0), (0, -2, 0), (1.4, 1.4, 0.5), (0, 1.4, 1.4)]
    poses = np.stack([look_at(e) for e in eyes])
    images = []
    for p in poses:
        o, d = trender.get_rays(t(p), h, w, focal)
        out = trender.render_rays(None, analytic_field, o.reshape(-1, 3), d.reshape(-1, 3),
                                  0.5, 4.0, 96)
        images.append(out["rgb"].reshape(h, w, 3).numpy())
    trainer = NeRFTrainer(near=0.5, far=4.0, n_samples=48, ray_batch=512, lr=2e-3,
                          model=tmodel.NeRFMLP(depth=3, width=48, skip_at=1, pos_freqs=5,
                                               dir_freqs=2), device="cpu")
    params, psnr = trainer.fit(np.stack(images), poses, focal, steps=250, seed=0,
                               log_every=50)
    assert psnr > 14.0, psnr
    assert [s for s, _, _ in trainer.history] == [50, 100, 150, 200, 250]
    out = textract.extract_rgbsigma_grid(trainer.fine_params(params), [-1.0, -1, -0.5],
                                         [1.0, 1, 0.5], poses[:2], max_res=16, chunk=2048)
    g = out["rgbsigma"]
    assert g.shape == (16, 16, 8, 4)
    assert g[8, 8, 4, 3] > g[0, 0, 0, 3] + 1.0
    assert g[8, 8, 4, 0] > g[8, 8, 4, 1]
