"""Core distributed runtime: tasks, actors, owned objects. Port of
``ray_tpu/core``.

Capability equivalent of the reference's C++ core (GCS + raylet + core worker;
SURVEY.md §1 layers 2-6): the control plane is a lightweight asyncio RPC
fabric and the object plane is host memory (shared memory + socket transfer).
Device tensors move through collectives inside the training and serving
programs (ray_tpu_torch.parallel), never through the object store: a CUDA
tensor put there arrives as a host tensor.
"""
