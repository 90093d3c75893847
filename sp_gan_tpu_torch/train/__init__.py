"""Training: state and optimizers, the G+D step, checkpoints and the
trainer (`python -m sp_gan_tpu_torch.train`)."""
