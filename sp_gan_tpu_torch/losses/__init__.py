"""GAN objectives, the discriminator's regularizers and the auxiliary
point losses."""

from sp_gan_tpu_torch.losses.cutmix import cutmix, cutmix_draws
from sp_gan_tpu_torch.losses.gan import dis_loss, gen_loss, mix_loss
from sp_gan_tpu_torch.losses.gp import r1_penalty, wgan_gp
from sp_gan_tpu_torch.losses.point_aux import (repulsion_loss, uniform_loss,
                                               uniform_loss_knn)
from sp_gan_tpu_torch.losses.shape_preserving import shape_preserving_loss

__all__ = ["cutmix", "cutmix_draws", "dis_loss", "gen_loss", "mix_loss",
           "r1_penalty", "repulsion_loss", "shape_preserving_loss",
           "uniform_loss", "uniform_loss_knn", "wgan_gp"]
