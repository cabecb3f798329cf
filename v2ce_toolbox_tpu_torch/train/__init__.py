"""Stage-1 training: losses, metrics, the PatchGAN discriminator, the
optimizers and the train and eval steps (`python -m
v2ce_toolbox_tpu_torch.train.main`)."""
