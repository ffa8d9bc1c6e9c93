"""Value serialization: pickle5 with ObjectRef tracking and device-tensor
down-conversion. Port of ``ray_tpu/core/serialization.py``.

Two jobs beyond plain pickle (reference parity:
python/ray/_private/serialization.py):

1. Track contained ObjectRefs during both directions — submitters need the
   dependency list, deserializers must register borrows.
2. Never ship device tensors through the object store: a CUDA
   ``torch.Tensor`` becomes a host tensor with the same dtype, shape and
   values. Device-to-device movement belongs to collectives; the object
   store is a host-memory plane. The exception is opt-in: in a process
   that called ``enable_device_objects()``, every strided tensor stays in
   that process's device-object store and travels as a ``DeviceRef``
   that the loading process fetches
   (:mod:`ray_tpu_torch.experimental.device_objects`).

Every strided ``torch.Tensor`` (CPU or CUDA) travels as its raw bytes, a
``uint8`` numpy view, plus its dtype name and shape, and is rebuilt on load
with ``view(dtype)``. So its data rides the out-of-band, one-copy path that
large numpy buffers take (:func:`dumps_oob`), bfloat16 included (numpy has
no bfloat16), instead of torch's in-band storage pickle. Tensors are
recognised by their type's module, as the reference recognises jax arrays:
this module never imports torch, and only a value that holds a tensor
makes the load side import it.
"""

from __future__ import annotations

import contextlib
import io
import pickle
import threading
from typing import Any

import cloudpickle

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.object_ref import ObjectRef


class _Context(threading.local):
    def __init__(self):
        self.collecting: list[ObjectRef] | None = None


_ctx = _Context()


class _Pickler(cloudpickle.Pickler):
    """cloudpickle base (closures/lambdas in args must travel — e.g. user
    transform fns inside data-plan ops) + ref tracking and device-array
    down-conversion on top."""

    def reducer_override(self, obj):
        if isinstance(obj, ObjectRef):
            if _ctx.collecting is not None:
                _ctx.collecting.append(obj)
            return NotImplemented  # fall through to ObjectRef.__reduce__
        mod = type(obj).__module__ or ""
        if (
            mod.partition(".")[0] == "torch"
            and type(obj).__name__ in ("Tensor", "Parameter")
            and str(getattr(obj, "layout", "")) == "torch.strided"
            and not getattr(obj, "is_quantized", False)
            and getattr(obj, "device", None) is not None
            and obj.device.type in ("cpu", "cuda")
        ):
            # Opt-in device objects (reference: tensor_transport): the
            # tensor stays in THIS process's store; a fetch-on-load
            # marker travels instead.
            from ray_tpu_torch.experimental import device_objects as _dev

            if _dev.intercept_active():
                return _dev.intercept_reduce(obj)
            # Default: device tensor -> host tensor of the same dtype,
            # shape and bits; its bytes ship as a uint8 numpy view
            # (out-of-band).
            return _reduce_tensor(obj)
        # cloudpickle's own reducer_override handles functions/classes.
        return super().reducer_override(obj)


def _reduce_tensor(t):
    import torch  # already loaded: ``t`` is a tensor

    host = t.detach().resolve_conj().resolve_neg()
    if host.device.type != "cpu":
        host = host.cpu()
    host = host.contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return (
        _rebuild_tensor,
        (
            raw,
            str(t.dtype).rpartition(".")[2],
            tuple(t.shape),
            bool(t.requires_grad),
            type(t).__name__ == "Parameter",
        ),
    )


def _rebuild_tensor(raw, dtype: str, shape: tuple, requires_grad: bool, param: bool):
    """Unpickle constructor for a tensor shipped by :func:`_reduce_tensor`:
    a host tensor over ``raw``'s bytes (no copy unless ``raw`` is
    read-only)."""
    import torch

    if not raw.flags.writeable:
        raw = raw.copy()
    t = torch.from_numpy(raw).view(getattr(torch, dtype)).reshape(shape)
    if param:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    if requires_grad:
        t.requires_grad_(True)
    return t


# Per-thread reusable pickle buffer: a batch of results (worker.push_batch
# replies) or a burst of arg encodes shares ONE growth buffer instead of
# reallocating per value (the ROADMAP "shared pickle buffer across a
# batch's results" item). The buffer is rewound WITHOUT truncating —
# truncate(0) would free the allocation and void the reuse — so its
# capacity persists across dumps; _take() slices the valid prefix out.
# Oversized one-off dumps release their memory at exit (the retain cap).
# The busy flag guards re-entrancy (a reducer that itself serializes).
class _Scratch(threading.local):
    def __init__(self):
        self.buf = io.BytesIO()
        self.busy = False


_scratch = _Scratch()
_SCRATCH_RETAIN_BYTES = 8 * 1024 * 1024


@contextlib.contextmanager
def _shared_pickle_buffer():
    if _scratch.busy:
        yield io.BytesIO()
        return
    _scratch.busy = True
    buf = _scratch.buf
    buf.seek(0)
    try:
        yield buf
    finally:
        if buf.seek(0, 2) > _SCRATCH_RETAIN_BYTES:
            buf.seek(0)
            buf.truncate()
        _scratch.busy = False


def _take(buf: io.BytesIO) -> bytes:
    """Copy out the bytes written by the current dump (position 0..tell);
    anything beyond is a previous dump's stale tail."""
    n = buf.tell()
    mv = buf.getbuffer()
    try:
        return bytes(mv[:n])
    finally:
        mv.release()


def dumps(value: Any) -> tuple[bytes, list[ObjectRef]]:
    """Serialize; returns (payload, contained_refs)."""
    prev = _ctx.collecting
    _ctx.collecting = refs = []
    try:
        with _shared_pickle_buffer() as buf:
            _Pickler(buf, protocol=5).dump(value)
            payload = _take(buf)
    finally:
        _ctx.collecting = prev
    return payload, refs


def loads(
    data: "bytes | memoryview | FramedPayload",
) -> tuple[Any, list[ObjectRef]]:
    """Deserialize; returns (value, contained_refs). Transparently handles
    plain pickle payloads, framed out-of-band payloads (flat RTB1 bytes),
    and live ``FramedPayload`` objects (the scatter-gather transport hands
    decoded frames over without flattening them).

    Ref collection happens via the ObjectRef deserialization hook, so nested
    refs anywhere in the value are found.
    """
    collected: list[ObjectRef] = []
    from ray_tpu_torch.core import object_ref as _or

    prev_hook = _or._on_ref_deserialized

    def hook(ref):
        collected.append(ref)
        if prev_hook is not None:
            prev_hook(ref)

    _or._on_ref_deserialized = hook
    try:
        if isinstance(data, FramedPayload):
            value = _loads_payload(data)
        else:
            # memoryview == bytes compares contents without the bytes()
            # allocation the old magic sniff paid per call.
            mv = memoryview(data)
            if len(mv) >= 4 and mv[:4] == _MAGIC:
                value = _loads_framed(mv)
            else:
                value = pickle.loads(data)
    finally:
        _or._on_ref_deserialized = prev_hook
    return value, collected


def _loads_payload(fp: "FramedPayload"):
    """Reconstruct a value from a live FramedPayload.

    Exclusive payloads (one decoded RPC frame's private reconstruction —
    task args, inline reply values) hand their views straight to the
    unpickler: the value's arrays alias the frame storage, zero copy, and
    mutating them is safe because nothing else references that frame.
    Shared payloads (the owner's stored inline snapshot) are copied once
    into fresh bytearrays so every get() is independently mutable. The
    scatter-gather kill switch disables view adoption too — the A/B "off"
    arm is the whole round-7 data plane, copies included."""
    if fp.exclusive and GLOBAL_CONFIG.rpc_scatter_gather_enabled:
        return pickle.loads(fp.header, buffers=fp.buffers)
    from ray_tpu_torch import _native

    buffers = []
    for b in fp.buffers:
        flat = _flat_view(b)
        out = bytearray(flat.nbytes)
        _native.copy_into(memoryview(out), flat)
        buffers.append(out)
    return pickle.loads(fp.header, buffers=buffers)


# ---------------------------------------------------------------------------
# Framed out-of-band payloads (pickle protocol-5 buffers)
#
# The hot path for array-bearing values: the pickle header carries only the
# object structure; each large buffer (numpy data) is copied ONCE, by the
# native multi-threaded memcpy, directly into the destination (shm mmap).
# Plain dumps() pays pickle's internal copy AND the write copy.
#
# Layout (little-endian):
#   "RTB1" | u32 nbuf | u64 header_len | u64 buf_len * nbuf
#   | header | pad-to-64 | buf0 | pad-to-64 | buf1 | ...
# ---------------------------------------------------------------------------

_MAGIC = b"RTB1"
_ALIGN = 64


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def _flat_view(b) -> memoryview:
    """1-D uint8 memoryview over any buffer (numpy shapes included)."""
    mv = b if isinstance(b, memoryview) else memoryview(b)
    if mv.ndim != 1 or mv.format != "B":
        mv = mv.cast("B")
    return mv


class FramedPayload:
    """A serialized value as (header, out-of-band buffers) plus the exact
    framed size — so writers can allocate once and copy once. Pickling a
    FramedPayload with protocol 5 keeps the buffers out-of-band
    (``PickleBuffer``), which is how the scatter-gather transport ships
    them to the socket without an intermediate flatten."""

    __slots__ = ("header", "buffers", "nbytes", "exclusive")

    def __init__(self, header: bytes, buffers: list):
        self.header = header
        self.buffers = buffers
        # True only for payloads reconstructed from a decoded RPC frame:
        # their buffers view that frame's private storage, so a consumer
        # may adopt them without copying (loads() returns arrays that view
        # the frame directly). False for locally-built payloads (the
        # sender's live value, the owner's stored snapshot) — those are
        # shared, and consumers must copy.
        self.exclusive = False
        off = 4 + 4 + 8 + 8 * len(buffers)
        off += _pad(len(header))
        for b in buffers:
            off += _pad(b.nbytes)
        self.nbytes = off

    def __reduce_ex__(self, protocol):
        if protocol >= 5:
            return (
                _rebuild_framed,
                (
                    self.header,
                    tuple(pickle.PickleBuffer(b) for b in self.buffers),
                ),
            )
        # Pre-5 protocols can't carry out-of-band buffers: flatten (only
        # reachable from user pickling, never the RPC/put hot paths).
        return (_framed_from_bytes, (self.to_bytes(),))

    def snapshot(self) -> "FramedPayload":
        """Copy the buffers once into private storage. put() semantics:
        the stored value must not alias caller memory (a later mutation of
        the numpy array that was put must not rewrite the object)."""
        from ray_tpu_torch import _native

        total = sum(b.nbytes for b in self.buffers)
        pool = memoryview(bytearray(total))
        out, off = [], 0
        for b in self.buffers:
            end = off + b.nbytes
            _native.copy_into(pool[off:end], _flat_view(b))
            out.append(pool[off:end])
            off = end
        return FramedPayload(self.header, out)

    def write_into(self, dst: memoryview) -> None:
        from ray_tpu_torch import _native

        import struct

        nbuf = len(self.buffers)
        struct.pack_into(
            f"<4sIQ{nbuf}Q",
            dst,
            0,
            _MAGIC,
            nbuf,
            len(self.header),
            *[b.nbytes for b in self.buffers],
        )
        off = 4 + 4 + 8 + 8 * nbuf
        dst[off : off + len(self.header)] = self.header
        off += _pad(len(self.header))
        for b in self.buffers:
            _native.copy_into(dst[off : off + b.nbytes], _flat_view(b))
            off += _pad(b.nbytes)

    def to_bytes(self) -> bytes:
        out = bytearray(self.nbytes)
        self.write_into(memoryview(out))
        return bytes(out)

    def write_stream(self, f) -> None:
        """Sequential single-copy write of the framed layout to a file."""
        import struct

        nbuf = len(self.buffers)
        f.write(
            struct.pack(
                f"<4sIQ{nbuf}Q",
                _MAGIC,
                nbuf,
                len(self.header),
                *[b.nbytes for b in self.buffers],
            )
        )
        f.write(self.header)
        pad = _pad(len(self.header)) - len(self.header)
        if pad:
            f.write(b"\x00" * pad)
        for b in self.buffers:
            f.write(_flat_view(b))
            pad = _pad(b.nbytes) - b.nbytes
            if pad:
                f.write(b"\x00" * pad)


def _rebuild_framed(header, buffers) -> FramedPayload:
    """Unpickle constructor for FramedPayload. Out-of-band loads hand the
    transport's decode views straight through (zero copy); in-band loads
    (scatter-gather off, pre-5 consumers) arrive as bytes/bytearray.
    Either way this reconstruction is private to the decoded frame, so
    the consumer may adopt the buffers (see _loads_payload)."""
    fp = FramedPayload(header, [_flat_view(b) for b in buffers])
    fp.exclusive = True
    return fp


def _framed_from_bytes(data: bytes) -> FramedPayload:
    mv = memoryview(data)
    import struct

    nbuf, header_len = struct.unpack_from("<IQ", mv, 4)
    lens = struct.unpack_from(f"<{nbuf}Q", mv, 16)
    off = 4 + 4 + 8 + 8 * nbuf
    header = bytes(mv[off : off + header_len])
    off += _pad(header_len)
    buffers = []
    for ln in lens:
        buffers.append(mv[off : off + ln])
        off += _pad(ln)
    return FramedPayload(header, buffers)


class OobBytes:
    """Wrapper that ships an existing bytes-like payload out-of-band.

    Plain ``bytes`` always pickle in-band (one copy into the pickle stream,
    another at the transport join); wrapping them lets the frame encoder
    emit the payload as its own socket segment. Deserializes to the raw
    buffer the unpickler was handed (bytes in-band, a memoryview of the
    decoded frame out-of-band) — consumers treat it as bytes-like."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data

    def __reduce_ex__(self, protocol):
        if protocol >= 5:
            return (_unwrap_oob, (pickle.PickleBuffer(self.data),))
        return (_unwrap_oob, (bytes(self.data),))


def _unwrap_oob(buf):
    return buf


def _loads_framed(mv: memoryview):
    import struct

    nbuf, header_len = struct.unpack_from("<IQ", mv, 4)
    lens = struct.unpack_from(f"<{nbuf}Q", mv, 16)
    off = 4 + 4 + 8 + 8 * nbuf
    header = mv[off : off + header_len]
    off += _pad(header_len)
    from ray_tpu_torch import _native

    buffers = []
    for ln in lens:
        # Copy out of the (possibly shm-backed) source: zero-copy views
        # would dangle if the blob is spilled or freed while the value
        # lives on. One memcpy — the same cost plain pickle.loads pays,
        # but multi-threaded on multicore hosts.
        out = bytearray(ln)
        _native.copy_into(memoryview(out), mv[off : off + ln])
        buffers.append(out)
        off += _pad(ln)
    return pickle.loads(header, buffers=buffers)


def dumps_oob(value: Any) -> tuple["FramedPayload | bytes", list[ObjectRef]]:
    """Like dumps(), but large contiguous buffers stay out-of-band.
    Returns plain bytes when the value carries no out-of-band buffers."""
    buffers: list = []
    threshold = max(1, GLOBAL_CONFIG.oob_min_buffer_bytes)

    def cb(pb: pickle.PickleBuffer) -> bool:
        # pickle semantics: a TRUTHY return keeps the buffer IN-band; a
        # falsy return takes it out-of-band (the inverse reads naturally
        # but is wrong).
        try:
            raw = pb.raw()
        except BufferError:
            return True  # non-contiguous: keep in-band
        if raw.nbytes < threshold:
            return True  # tiny: framing overhead beats the copy win
        buffers.append(raw)
        return False

    prev = _ctx.collecting
    _ctx.collecting = refs = []
    try:
        with _shared_pickle_buffer() as buf:
            _Pickler(buf, protocol=5, buffer_callback=cb).dump(value)
            header = _take(buf)
    finally:
        _ctx.collecting = prev
    if not buffers:
        return header, refs
    return FramedPayload(header, buffers), refs
