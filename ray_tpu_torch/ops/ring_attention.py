"""Ring attention: causal attention with the sequence split over a mesh
axis, K/V blocks travelling round the ring. Port of
``ray_tpu/ops/ring_attention.py``.

Each rank along ``axis`` (``sp``) holds a contiguous block of ``S/sp``
positions of q, k and v. At step ``t`` it scores its q against the K/V
block that started on rank ``(idx - t) % sp``, in f32, masks by global
positions, merges the block into an online softmax, and passes K/V on to
the next rank with :func:`~ray_tpu_torch.parallel.sharding.ppermute`. A
rank's scores are ``[S/sp, S/sp]`` a step, never ``[S, S]``. Causality at
block granularity comes from the global positions: a wholly future block
masks to ``-1e30`` and adds nothing (the plain ring; a schedule that skips
those blocks would halve the work).

The reference's ring is plain ``jnp`` (not a Pallas kernel) and so is this
one: plain torch operations and the shift. Its backward is autograd
through the loop: each step's residuals are kept, as the reference's
un-rematerialised ``scan`` keeps them, and the K/V gradients travel the
ring the other way (the shift's transpose).
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.parallel.sharding import ppermute

_NEG_INF = -1e30


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "sp",
    scale: float | None = None,
) -> torch.Tensor:
    """Causal attention of this rank's ``[B, H, S/sp, D]`` blocks of q, k
    and v, where rank ``r`` along ``axis`` holds positions
    ``[r*S/sp, (r+1)*S/sp)``; returns this rank's block of the output in
    q's dtype. Every rank along ``axis`` must call it together."""
    sp, idx = mesh.size(axis), mesh.coordinate(axis)
    s_local = q.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    pos = torch.arange(s_local, device=q.device)
    rows = idx * s_local + pos  # global q positions
    qf = q.float() * scale
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:3], _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    # K and V travel as one tensor, so each step is one exchange and the
    # two gradients cannot pair with each other's in backward.
    kv = torch.stack([k, v])
    for t in range(sp):
        src = (idx - t) % sp  # the rank whose block kv holds
        cols = src * s_local + pos
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kv[0].float())
        s = torch.where(rows[:, None] >= cols[None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, kv[1].float())
        m = m_new
        if t < sp - 1:  # the last block goes nowhere
            kv = ppermute(kv, mesh, axis)
    return (acc / l[..., None]).to(q.dtype)
