"""Runtime switches, overridable via RAY_TPU_<NAME> env vars. Port of the
part of ``ray_tpu/core/config.py`` that the port reads.

The reference's ``Config`` is one typed table of every runtime knob; the
port copies only the fields its ported code consults, read from the same
environment variables with the same parsing, into one mutable
``GLOBAL_CONFIG`` (tests flip a switch on it and restore it):

- ``metrics_enabled`` (``RAY_TPU_METRICS_ENABLED``): the telemetry kill
  switch. Off, every record site of the engine's serving series is
  skipped, so the telemetry tax can be measured; the registry itself
  stays up.
- ``flightrec``, ``flightrec_ring_size``, ``flightrec_dump_dir``
  (``RAY_TPU_FLIGHTREC``, ...): the flight recorder
  (:mod:`ray_tpu_torch.util.flightrec`) and its per-plane ring capacity
  and postmortem directory (empty: ``ray_tpu_flightrec`` under the
  system's temporary directory).
- ``spec_decode`` (``RAY_TPU_SPEC_DECODE``): the speculative-decoding kill
  switch. Off, an engine builds no draft model and every step is the
  vanilla one, whatever ``LLMConfig.spec_decode_tokens`` says; greedy
  outputs are the same either way.
- ``faults`` (``RAY_TPU_FAULTS``): the seeded fault-injection spec,
  ``"<seed>:<rule>[;<rule>...]"``, parsed at import by
  :mod:`ray_tpu_torch.core.faults` into the process-wide injector; empty
  (the default) is chaos off. Spawned processes inherit the variable.
- ``xfer_armed_cap`` (``RAY_TPU_XFER_ARMED_CAP``): how many armed entries
  the transfer fabric (:mod:`ray_tpu_torch.experimental.transfer`) keeps
  awaiting a pull before it evicts the oldest past its TTL.
"""

from __future__ import annotations

import dataclasses
import os


def _env(name: str, default):
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    t = type(default)
    if t is bool:
        return raw.lower() in ("1", "true", "yes")
    return t(raw)


@dataclasses.dataclass
class Config:
    metrics_enabled: bool = True
    flightrec: bool = True
    flightrec_ring_size: int = 4096
    flightrec_dump_dir: str = ""
    spec_decode: bool = True
    faults: str = ""
    xfer_armed_cap: int = 16


def load_config() -> Config:
    cfg = Config()
    for f in dataclasses.fields(Config):
        setattr(cfg, f.name, _env(f.name, getattr(cfg, f.name)))
    return cfg


GLOBAL_CONFIG = load_config()
