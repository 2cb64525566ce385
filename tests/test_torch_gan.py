"""Port parity: `repro_torch.models.gan` and `repro_torch.data` against
`repro`, with converted weights and the JAX package's latent draw handed
to the port's field.

Tolerance: float32 convolutions summed in another order (PyTorch's CPU
kernels vs XLA's) agree to a few ulps per output; through three layers and
their gradients that is rtol 1e-4, with an absolute floor of 1e-5 of the
largest entry for gradients that cancel toward zero."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.data import synthetic as JD
from repro.models import gan as JG
from repro_torch import tree as T
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.data import synthetic as TD
from repro_torch.models import gan as TG
from torch_ranks import one_thread  # noqa: F401 (autouse)

FULL = jget("dcgan32")
CFGS = {"reduced": FULL.reduced(), "dcgan32": FULL,
        "mlp": JG.GANConfig(name="mlp", image_size=0, latent_dim=8)}


def _tcfg(cfg):
    return TG.GANConfig(**{f: getattr(cfg, f)
                           for f in cfg.__dataclass_fields__})


def _close(actual, desired, rtol=1e-4, floor=1e-5):
    desired = np.asarray(desired, np.float32)
    atol = floor * max(float(np.abs(desired).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=rtol,
                               atol=atol)


def _real(cfg, key, n):
    if cfg.is_image:
        return JD.procedural_images(key, n, cfg.image_size, cfg.channels)
    sample, _ = JD.gaussian_mixture_sampler()
    return sample(key, n)


@pytest.mark.parametrize("name", list(CFGS))
def test_field_grads_and_loss_match(name):
    cfg = CFGS[name]
    B = 4
    rs = np.random.RandomState(1)
    # weights away from their tiny init scale, so every layer matters
    params = jax.tree.map(
        lambda w: w + 0.05 * rs.randn(*w.shape).astype(np.float32),
        JG.init(jax.random.key(1), cfg))
    real = _real(cfg, jax.random.key(2), B)
    rng = jax.random.key(3)
    gj, mj = jax.jit(JG.gan_field_fn(cfg))(params, {"real": real}, rng)
    z = np.asarray(jax.random.normal(rng, (B, cfg.latent_dim)))
    tp = params_from_jax(jax.device_get(params))
    gt, mt = TG.gan_field_fn(_tcfg(cfg))(
        tp, {"real": torch.from_numpy(np.array(real))},
        z=torch.from_numpy(z))
    paths, jl = T.flatten(jax.device_get(gj))
    for path, a, b in zip(paths, jl, T.flatten_up_to(paths, gt)):
        assert tuple(b.shape) == a.shape, path
        _close(b.numpy(), a)
    for k in ("loss", "loss_g", "loss_d"):
        _close(mt[k].numpy(), mj[k], floor=1e-6)


@pytest.mark.parametrize("name", ["reduced", "dcgan32"])
def test_generate_and_discriminate_nhwc(name):
    cfg = CFGS[name]
    params = jax.tree.map(
        lambda w: 0.1 * jax.random.normal(jax.random.key(w.size), w.shape),
        JG.init(jax.random.key(0), cfg))
    tp = params_from_jax(jax.device_get(params))
    z = np.random.RandomState(0).randn(3, cfg.latent_dim).astype(np.float32)
    xj = JG.generate(params, cfg, jnp.asarray(z))
    xt = TG.generate(tp, _tcfg(cfg), torch.from_numpy(z))
    assert tuple(xt.shape) == xj.shape == (3, cfg.image_size,
                                           cfg.image_size, cfg.channels)
    _close(xt.numpy(), xj)
    _close(TG.discriminate(tp, _tcfg(cfg), xt).numpy(),
           JG.discriminate(params, cfg, xj))


@pytest.mark.parametrize("size,cin,cout", [(8, 3, 5), (32, 4, 2)])
def test_conv_and_conv_transpose_layouts(size, cin, cout):
    """HWIO weights, stride 2, SAME: conv_general_dilated and conv_transpose
    against F.conv2d / F.conv_transpose2d (the flip) on random weights."""
    rs = np.random.RandomState(size)
    p = {"w": rs.randn(4, 4, cin, cout).astype(np.float32),
         "b": rs.randn(cout).astype(np.float32)}
    x = rs.randn(2, size, size, cin).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _close(TG.conv(tp, tx).permute(0, 2, 3, 1).numpy(),
           JG.conv(jp, jnp.asarray(x)), floor=1e-6)
    pt = {"w": torch.from_numpy(rs.randn(4, 4, cin, cout).astype(np.float32)),
          "b": tp["b"]}
    _close(TG.conv_t(pt, tx).permute(0, 2, 3, 1).numpy(),
           JG.conv_t({"w": jnp.asarray(pt["w"].numpy()), "b": jp["b"]},
                     jnp.asarray(x)), floor=1e-6)


def test_clip_disc_and_convert_round_trip():
    cfg = CFGS["reduced"]
    params = jax.tree.map(lambda w: w + 0.3, JG.init(jax.random.key(0), cfg))
    tp = params_from_jax(jax.device_get(params))
    back = params_to_jax(TG.clip_disc(tp, _tcfg(cfg)))
    want = jax.device_get(JG.clip_disc(params, cfg))
    paths, wl = T.flatten(want)
    for a, b in zip(wl, T.flatten_up_to(paths, back)):
        np.testing.assert_array_equal(b, a)


def test_procedural_images_match_given_the_same_draws():
    key, n, size, C = jax.random.key(5), 6, 32, 3
    ks = jax.random.split(key, 5)
    cx = jax.random.uniform(ks[0], (n, 1, 1, 1), minval=0.25, maxval=0.75)
    cy = jax.random.uniform(ks[1], (n, 1, 1, 1), minval=0.25, maxval=0.75)
    sig = jax.random.uniform(ks[2], (n, 1, 1, 1), minval=0.05, maxval=0.15)
    hue = jax.random.uniform(ks[3], (n, 1, 1, C))
    want = JD.procedural_images(key, n, size, C)
    got = TD.render_blobs(*(torch.from_numpy(np.asarray(a))
                            for a in (cx, cy, sig, hue)), size)
    _close(got.numpy(), want, rtol=1e-5, floor=1e-6)
    drawn = TD.procedural_images(n, size, C,
                                 generator=torch.Generator().manual_seed(0))
    assert tuple(drawn.shape) == (n, size, size, C)
    assert float(drawn.min()) >= -1 and float(drawn.max()) <= 1


def test_gaussian_mixture_sampler_matches_given_the_same_draws():
    sj, cj = JD.gaussian_mixture_sampler()
    st, ct = TD.gaussian_mixture_sampler()
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    key = jax.random.key(9)
    k1, k2 = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k1, (16,), 0, 8))
    noise = np.asarray(jax.random.normal(k2, (16, 2)))
    got = st(16, idx=torch.from_numpy(idx).long(),
             noise=torch.from_numpy(noise))
    _close(got.numpy(), sj(key, 16), rtol=1e-6, floor=1e-7)
