"""Training: the one-GPU train step (:mod:`ray_tpu_torch.train.spmd`)."""
