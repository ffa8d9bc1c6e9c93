"""Accelerator detection for node bootstrap. The port's counterpart of
``ray_tpu/accelerators/``: a node advertises its CUDA cards as the ``GPU``
resource (:mod:`ray_tpu_torch.accelerators.gpu`)."""
