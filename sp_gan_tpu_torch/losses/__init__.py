"""GAN objectives and the discriminator's regularizers."""

from sp_gan_tpu_torch.losses.cutmix import cutmix, cutmix_draws
from sp_gan_tpu_torch.losses.gan import dis_loss, gen_loss, mix_loss
from sp_gan_tpu_torch.losses.gp import r1_penalty, wgan_gp

__all__ = ["cutmix", "cutmix_draws", "dis_loss", "gen_loss", "mix_loss",
           "r1_penalty", "wgan_gp"]
