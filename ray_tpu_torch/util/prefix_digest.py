"""Stable prefix digests the LLM engine advertises for prefix-aware routing.
Port of the part of ``ray_tpu/util/prefix_digest.py`` the engine uses.

A digest is the blake2b-8 (64-bit) hash of a rolling chain over
``prefix_chunk``-sized token blocks, ``H_p = blake2b(H_{p-c} || block)``,
each block serialized as little-endian int32. The router side must hash the
same bytes to the same values, so this is the reference's contract exactly.
"""

from __future__ import annotations

import hashlib
import struct

# Scheme tag for the byte-level default tokenizer (BOS(256) + UTF-8 bytes).
BYTE_BOS_SCHEME = "byte-bos"


def _h(prev: bytes, block_ids) -> bytes:
    payload = prev + struct.pack(f"<{len(block_ids)}i", *block_ids)
    return hashlib.blake2b(payload, digest_size=8).digest()


def chain_digests(
    token_ids, chunk: int, max_blocks: int = 0, strict: bool = True
) -> list[int]:
    """Rolling digests of ``token_ids``'s chunk-aligned prefixes, shortest
    first: entry i covers tokens[: (i+1)*chunk]. Strict (at least one token
    must remain un-covered) mirrors the engine's pool alignment for
    prompt-side hashing; pool entries advertise with strict=False."""
    if chunk <= 0 or len(token_ids) < chunk + (1 if strict else 0):
        return []
    limit = ((len(token_ids) - (1 if strict else 0)) // chunk) * chunk
    if max_blocks:
        limit = min(limit, max_blocks * chunk)
    out = []
    h = b""
    for p in range(chunk, limit + 1, chunk):
        h = _h(h, token_ids[p - chunk : p])
        out.append(int.from_bytes(h, "little"))
    return out
