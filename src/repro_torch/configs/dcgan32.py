"""dcgan32: the paper's own experimental architecture, a DCGAN-style
generator/discriminator pair for 32x32x3 images trained with the WGAN loss
(counterpart of `repro.configs.dcgan32`, same numbers)."""
from repro_torch.models.gan import GANConfig

CONFIG = GANConfig(
    name="dcgan32",
    image_size=32,
    channels=3,
    latent_dim=128,
    base_width=64,
)
