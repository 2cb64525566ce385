"""GANs of the paper's experiments (counterpart of `repro.models.gan`).

  * DCGAN-style conv generator/discriminator for 32x32 images.
  * MLP generator/discriminator for 2-D Gaussian mixtures.

Loss: WGAN (paper Eq. 3), L_D = -E[D(x)] + E[D(G(z))], L_G = -E[D(G(z))];
the field F(w) = [∇θ L_G, ∇φ L_D] is what DQGAN exchanges.

Parameters keep the JAX layout (conv ``w`` HWIO, linear ``w`` (d_in,
d_out)), because the bucket layout flattens them as stored. Convolutions
run in PyTorch's NCHW/OIHW and permute the weights at call time; images
enter and leave the public functions as NHWC, like the JAX package's.

Under a model group (`parallel.tensor`, the trainer's 'model' axis) the
DCGAN's `gen.fc` is column-parallel and its output is gathered before
the reshape; `disc.fc`'s single output column does not shard, and the
convolutions stay replicated, as the rules lay them out.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.parallel import tensor as TP

from .layers import col_linear, linear, linear_init


@dataclass(frozen=True)
class GANConfig:
    name: str = "dcgan32"
    arch_type: str = "gan"
    image_size: int = 32          # 0 -> vector data (MLP GAN)
    channels: int = 3
    latent_dim: int = 128
    base_width: int = 64
    data_dim: int = 2             # for MLP GAN
    hidden: int = 128
    weight_clip: float = 0.1      # WGAN Lipschitz via clipping
    # critic-to-generator learning-rate ratio (scales the disc field)
    disc_grad_mult: float = 5.0

    @property
    def is_image(self) -> bool:
        return self.image_size > 0

    def reduced(self) -> "GANConfig":
        return GANConfig(name=self.name + "-smoke", image_size=8, channels=1,
                         latent_dim=16, base_width=8)


# --------------------------------------------------------------------------- #
# conv helpers: x NCHW inside, weights HWIO as stored
# --------------------------------------------------------------------------- #
def conv_init(kh, kw, cin, cout, *, generator=None, device=None):
    return {"w": torch.randn((kh, kw, cin, cout), generator=generator,
                             device=device) * 0.02,
            "b": torch.zeros((cout,), device=device)}


def _same_pads(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(p, x, stride=2):
    """lax.conv_general_dilated(x, w, stride, "SAME") in NCHW."""
    kh, kw = p["w"].shape[:2]
    ph, pw = _same_pads(x.shape[2], kh, stride), _same_pads(x.shape[3], kw,
                                                            stride)
    if ph[0] != ph[1] or pw[0] != pw[1]:
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        ph, pw = (0, 0), (0, 0)
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], stride=stride,
                    padding=(ph[0], pw[0]))


def conv_t(p, x, stride=2):
    """lax.conv_transpose(x, w, stride, "SAME") in NCHW, for the DCGAN's
    4x4 stride-2 kernels (output = stride·input). lax.conv_transpose does
    not flip the kernel and PyTorch's does, hence the flip."""
    k = p["w"].shape[0]
    return F.conv_transpose2d(x, p["w"].flip(0, 1).permute(2, 3, 0, 1),
                              p["b"], stride=stride, padding=(k - stride) // 2)


def _bn_free_act(x):  # DCGAN without batchnorm (WGAN-friendly): leaky relu
    return F.leaky_relu(x, 0.2)


# --------------------------------------------------------------------------- #
# DCGAN
# --------------------------------------------------------------------------- #
def dcgan_init(cfg: GANConfig, *, generator=None, device=None):
    bw = cfg.base_width
    s0 = cfg.image_size // 8  # three stride-2 upsamples
    kw = dict(generator=generator, device=device)
    gen = {
        "fc": linear_init(cfg.latent_dim, s0 * s0 * bw * 4, True, **kw),
        "c1": conv_init(4, 4, bw * 4, bw * 2, **kw),
        "c2": conv_init(4, 4, bw * 2, bw, **kw),
        "c3": conv_init(4, 4, bw, cfg.channels, **kw),
    }
    disc = {
        "c1": conv_init(4, 4, cfg.channels, bw, **kw),
        "c2": conv_init(4, 4, bw, bw * 2, **kw),
        "c3": conv_init(4, 4, bw * 2, bw * 4, **kw),
        "fc": linear_init(s0 * s0 * bw * 4, 1, True, **kw),
    }
    return {"gen": gen, "disc": disc}


def _dcgan_generate_nchw(gen, cfg: GANConfig, z):
    bw = cfg.base_width
    s0 = cfg.image_size // 8
    n = s0 * s0 * bw * 4
    h = col_linear(gen["fc"], z, n)
    if TP.shards(n):     # column-parallel: gathered before the reshape
        h = TP.gather_from(h)
    # the JAX package reshapes to NHWC here; NCHW is a permute of that
    x = F.relu(h).reshape(-1, s0, s0, bw * 4)
    x = x.permute(0, 3, 1, 2)
    x = F.relu(conv_t(gen["c1"], x))
    x = F.relu(conv_t(gen["c2"], x))
    return torch.tanh(conv_t(gen["c3"], x))


def _dcgan_discriminate_nchw(disc, cfg: GANConfig, x):
    h = _bn_free_act(conv(disc["c1"], x))
    h = _bn_free_act(conv(disc["c2"], h))
    h = _bn_free_act(conv(disc["c3"], h))
    # flatten in NHWC order, as the JAX package's fc weights expect
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return linear(disc["fc"], h)[:, 0]


def dcgan_generate(gen, cfg: GANConfig, z):
    """Images (B, H, W, C) in [-1, 1]."""
    return _dcgan_generate_nchw(gen, cfg, z).permute(0, 2, 3, 1)


def dcgan_discriminate(disc, cfg: GANConfig, x):
    """Critic scores (B,) of NHWC images."""
    return _dcgan_discriminate_nchw(disc, cfg, x.permute(0, 3, 1, 2))


# --------------------------------------------------------------------------- #
# MLP GAN (synthetic 2-D data)
# --------------------------------------------------------------------------- #
def mlp_gan_init(cfg: GANConfig, *, generator=None, device=None):
    h = cfg.hidden
    kw = dict(generator=generator, device=device)
    gen = {
        "l1": linear_init(cfg.latent_dim, h, True, **kw),
        "l2": linear_init(h, h, True, **kw),
        "l3": linear_init(h, cfg.data_dim, True, **kw),
    }
    disc = {
        "l1": linear_init(cfg.data_dim, h, True, **kw),
        "l2": linear_init(h, h, True, **kw),
        "l3": linear_init(h, 1, True, **kw),
    }
    return {"gen": gen, "disc": disc}


def mlp_generate(gen, cfg, z):
    h = F.relu(linear(gen["l1"], z))
    h = F.relu(linear(gen["l2"], h))
    return linear(gen["l3"], h)


def mlp_discriminate(disc, cfg, x):
    h = F.leaky_relu(linear(disc["l1"], x), 0.2)
    h = F.leaky_relu(linear(disc["l2"], h), 0.2)
    return linear(disc["l3"], h)[:, 0]


# --------------------------------------------------------------------------- #
# the min-max field (what DQGAN transports)
# --------------------------------------------------------------------------- #
def generate(params, cfg, z):
    f = dcgan_generate if cfg.is_image else mlp_generate
    return f(params["gen"], cfg, z)


def discriminate(params, cfg, x):
    f = dcgan_discriminate if cfg.is_image else mlp_discriminate
    return f(params["disc"], cfg, x)


def init(cfg: GANConfig, *, generator=None, device=None):
    return (dcgan_init if cfg.is_image else mlp_gan_init)(
        cfg, generator=generator, device=device)


def gan_field_fn(cfg: GANConfig):
    """field_fn(params, batch, z=None, generator=None) -> (grads, metrics).

    batch: {"real": real samples} (images NHWC). z: the (B, latent) draw,
    from `generator` on the batch's device when not given: the draw
    `field_fn.draw_z(batch, generator)` makes, which a caller may also
    take ahead of the field."""
    if cfg.is_image:
        genf, disc = _dcgan_generate_nchw, _dcgan_discriminate_nchw
    else:
        genf, disc = mlp_generate, mlp_discriminate

    def draw_z(batch, generator=None):
        real = batch["real"]
        return torch.randn((real.shape[0], cfg.latent_dim),
                           generator=generator, device=real.device)

    def field_fn(params, batch, z=None, generator=None):
        real = batch["real"]
        if z is None:
            z = draw_z(batch, generator)
        if cfg.is_image:
            real = real.permute(0, 3, 1, 2)
        gpaths, gleaves = T.flatten(params["gen"])
        dpaths, dleaves = T.flatten(params["disc"])
        gleaves = [w.detach().requires_grad_() for w in gleaves]
        dleaves = [w.detach().requires_grad_() for w in dleaves]
        gp, dp = T.unflatten(gpaths, gleaves), T.unflatten(dpaths, dleaves)
        with torch.enable_grad():
            d_fake = disc(dp, cfg, genf(gp, cfg, z))
            d_real = disc(dp, cfg, real)
            lg = -d_fake.mean()
            # ∇φ of E[D(G(z))] does not flow into G, so the same d_fake
            # serves L_D (the JAX package stops the gradient there)
            ld = -d_real.mean() + d_fake.mean()
            g_gen = torch.autograd.grad(lg, gleaves, retain_graph=True)
            g_disc = torch.autograd.grad(ld, dleaves)
        grads = {"gen": T.unflatten(gpaths, list(g_gen)),
                 "disc": T.unflatten(dpaths, [cfg.disc_grad_mult * g
                                              for g in g_disc])}
        lg, ld = lg.detach(), ld.detach()
        return grads, {"loss": ld + lg, "loss_g": lg, "loss_d": ld}

    field_fn.draw_z = draw_z
    return field_fn


def clip_disc(params, cfg: GANConfig):
    """WGAN weight clipping (applied to the discriminator after a step)."""
    c = cfg.weight_clip
    return {"gen": params["gen"],
            "disc": T.tree_map(lambda w: w.clamp(-c, c), params["disc"])}
