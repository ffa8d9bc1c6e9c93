"""Collective helpers of the port. Only the two-level topology model
(:mod:`ray_tpu_torch.util.collective.topology`) is ported, which the train
tier's worker group derives its context from; the collective groups
themselves are ``torch.distributed``'s."""
