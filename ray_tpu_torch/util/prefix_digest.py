"""Stable prefix digests shared by the LLM engine and the serve router.
Port of ``ray_tpu/util/prefix_digest.py``.

The engine pools chunk-aligned prompt prefixes and advertises what it
holds; the router hashes an incoming prompt's leading token blocks and
biases replica choice toward a pool that already holds them. Both sides
must hash the SAME byte stream to the SAME value across processes, so this
module is the one copy of that contract:

- a digest is the blake2b-8 (64-bit) hash of a rolling chain over
  ``prefix_chunk``-sized token blocks, ``H_p = blake2b(H_{p-c} || block)``,
  each block serialized as little-endian int32;
- token ids come from the engine's tokenizer. The router has only text,
  so text-side hashing exists ONLY for the byte-level default tokenizer
  (``ByteTokenizer``: BOS(256) + UTF-8 bytes — scheme tag "byte-bos").
  Any other tokenizer makes router-side digests miss and routing falls
  back to pure load, which is correct, just unaided.

No torch or llm imports here: the router runs in driver and proxy
processes that must not pay a torch import for routing.
"""

from __future__ import annotations

import hashlib
import struct

# Scheme tag the LLM deployment advertises in its routing-affinity config;
# routers only attempt text-side hashing when they recognize it.
BYTE_BOS_SCHEME = "byte-bos"
_BOS_ID = 256  # ByteTokenizer.bos_id, duplicated to avoid the llm import

# Router-side cap on how many leading blocks are hashed per request: a
# pathological 1 MB prompt must not pay an unbounded hashing tax in the
# routing hot path. 64 blocks x 32-token default chunk = 2048 tokens of
# prefix discrimination, past any realistic shared system prompt.
MAX_PROMPT_BLOCKS = 64


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


def chat_prompt(messages) -> str:
    """THE chat-endpoint prompt construction, shared by the LLM replica
    (which tokenizes it) and the serve router (which hashes it for
    prefix-affinity routing). Two diverging copies would silently turn
    every chat request into a digest miss — keep exactly one."""
    return "\n".join(
        f"{m.get('role', 'user')}: {m.get('content', '')}"
        for m in messages
        if isinstance(m, dict)
    )


def prompt_digests(text: str, chunk: int, scheme: str) -> list[int]:
    """Text-side twin of :func:`chain_digests` for the byte-level default
    tokenizer; [] for any scheme this module does not recognize (the
    router then routes on load alone)."""
    if scheme != BYTE_BOS_SCHEME:
        return []
    ids = [_BOS_ID, *text.encode("utf-8")]
    return chain_digests(ids, chunk, max_blocks=MAX_PROMPT_BLOCKS)
