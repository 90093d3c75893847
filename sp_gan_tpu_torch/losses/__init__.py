"""GAN objectives."""

from sp_gan_tpu_torch.losses.gan import dis_loss, gen_loss, mix_loss

__all__ = ["dis_loss", "gen_loss", "mix_loss"]
