"""Deterministic, seeded fault injection. Port of ``ray_tpu/core/faults.py``.

One process-wide :class:`FaultInjector` is consulted at the port's
failure-prone seams:

==========  =====================  =======================================
site        actions                injected where
==========  =====================  =======================================
``send``    drop delay dup sever   ``protocol.Connection._send`` (per frame)
``recv``    drop delay dup         ``protocol.Connection._handle_frame``
``node``    kill_worker            node worker-monitor sweep (a leased
                                   task worker)
``node``    lease_delay            ``node._h_request_lease`` entry
``node``    preempt                node worker-monitor sweep (preemption
                                   notice, then a graceful self-drain)
``gcs``     heartbeat_blackhole    ``gcs._h_node_heartbeat`` (partition)
``store``   pull_corrupt           ``node._h_fetch_object`` (flip bytes)
``store``   pull_lose              ``node._h_fetch_object`` (raise)
``kvship``  sever delay            the disaggregated-serving KV handoff
                                   pull (:func:`ray_tpu_torch.llm.disagg.
                                   pull_kv`): ``sever`` fails the pull, and
                                   the decode engine falls back to local
                                   (chunked) prefill with the same greedy
                                   tokens; ``delay`` sleeps the pull.
                                   ``match`` globs the request id.
==========  =====================  =======================================

The parser knows every site of the reference (``chan``, ``dcn``, ...), so
one ``RAY_TPU_FAULTS`` value parses the same in both packages; rules for
sites the port does not have yet never fire here. The variable is
inherited by spawned workers.

Determinism: every rule owns a ``random.Random`` seeded from the string
``"<injector seed>:<rule index>:<site>.<action>"``, and consumes exactly one
draw per matching opportunity. So a schedule replays bit-identically from
its seed for the same sequence of decision points, and takes the same
decisions as the reference's injector for the same seed and spec, call
for call. Probability-1 rules replay identically whatever the
interleaving.

Off by default, and then every seam pays one module-attribute check
(``active() is None``). Enable per process with

    RAY_TPU_FAULTS="<seed>:<rule>[;<rule>...]"
    rule  = <site>.<action>[,<field>=<value>...]
    field = p (probability, default 1) | ms (delay millis; "inf" = blackhole)
          | match (fnmatch glob on the operation name; default *)
          | peer (fnmatch glob on the peer "host:port"; default *)
          | count (fire at most N times; 0 = unlimited)
          | after (skip the first N matching opportunities)

or :func:`install` an injector from :func:`parse_spec` in-process.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math
import random
import threading
from typing import Optional, Sequence

from ray_tpu_torch.core.config import GLOBAL_CONFIG

INF = math.inf

# Every site and action of the reference's table (ray_tpu/core/faults.py),
# so a spec parses and validates the same in both packages.
_SITE_ACTIONS = {
    "send": frozenset({"drop", "delay", "dup", "sever"}),
    "recv": frozenset({"drop", "delay", "dup"}),
    "node": frozenset({"kill_worker", "lease_delay", "preempt"}),
    "gcs": frozenset({"heartbeat_blackhole"}),
    "store": frozenset({"pull_corrupt", "pull_lose"}),
    "chan": frozenset({"read_delay"}),
    "dcn": frozenset({"sever", "delay"}),
    "kvship": frozenset({"sever", "delay"}),
    "weightsync": frozenset({"sever", "delay"}),
    "envrun": frozenset({"kill"}),
    "datapool": frozenset({"kill"}),
    "elastic": frozenset({"sever", "delay"}),
}


@dataclasses.dataclass
class FaultRule:
    site: str
    action: str
    prob: float = 1.0
    delay_s: float = 0.0
    match: str = "*"
    peer: str = "*"
    count: int = 0  # max fires; 0 = unlimited
    after: int = 0  # skip the first N matching opportunities
    # runtime state (reset when the rule is installed into an injector)
    seen: int = 0
    fired: int = 0
    rng: Optional[random.Random] = None
    _lock: Optional[threading.Lock] = None

    def __post_init__(self):
        actions = _SITE_ACTIONS.get(self.site)
        if actions is None:
            raise ValueError(
                f"unknown fault site {self.site!r} (sites: {sorted(_SITE_ACTIONS)})"
            )
        if self.action not in actions:
            raise ValueError(
                f"unknown action {self.action!r} for site {self.site!r} "
                f"(actions: {sorted(actions)})"
            )

    def choice(self, seq: Sequence):
        """Deterministic pick from the rule's own stream (victim choice).
        Takes the injector lock: in-process clusters run several node
        monitor loops against one injector, and an unlocked draw would
        interleave the stream differently run to run."""
        with self._lock:
            return seq[self.rng.randrange(len(seq))]


class FaultInjector:
    """A seeded schedule of fault rules. The first matching rule that
    fires wins a decision point; callers switch on ``rule.action``."""

    def __init__(self, seed: int, rules: Sequence[FaultRule]):
        self.seed = int(seed)
        self.rules = list(rules)
        # Rule state (seen/fired/rng) mutates under one lock, or count=
        # rules overfire and a failing seed stops being a repro.
        self._lock = threading.Lock()
        for i, r in enumerate(self.rules):
            r.rng = random.Random(f"{self.seed}:{i}:{r.site}.{r.action}")
            r.seen = 0
            r.fired = 0
            r._lock = self._lock

    def decide(
        self,
        site: str,
        name: str = "",
        peer: str = "",
        actions: Optional[frozenset] = None,
    ) -> Optional[FaultRule]:
        """The rule to apply at this decision point, or None. ``actions``
        restricts to what the call site can apply. Each matching rule
        consumes exactly one probability draw per opportunity, which keeps
        replays seed-exact."""
        fired_rule = None
        with self._lock:
            for r in self.rules:
                if r.site != site:
                    continue
                if actions is not None and r.action not in actions:
                    continue
                if r.match != "*" and not fnmatch.fnmatchcase(name, r.match):
                    continue
                if r.peer != "*" and not fnmatch.fnmatchcase(peer, r.peer):
                    continue
                r.seen += 1
                if r.seen <= r.after:
                    continue
                if r.count and r.fired >= r.count:
                    continue
                if r.prob < 1.0 and r.rng.random() >= r.prob:
                    continue
                r.fired += 1
                fired_rule = r
                break
        if fired_rule is not None:
            # Outside the injector lock: the flight recorder takes its own
            # ring lock and the dump does file IO.
            _flightrec_fire(fired_rule, name)
        return fired_rule

    def stats(self) -> list:
        with self._lock:
            return [
                {"rule": f"{r.site}.{r.action}", "match": r.match, "seen": r.seen, "fired": r.fired}
                for r in self.rules
            ]


def parse_rule(text: str) -> FaultRule:
    parts = [p.strip() for p in text.split(",") if p.strip()]
    if not parts:
        raise ValueError("empty fault rule")
    site, _, action = parts[0].partition(".")
    kwargs: dict = {}
    for p in parts[1:]:
        k, eq, v = p.partition("=")
        if not eq:
            raise ValueError(f"fault rule field {p!r} is not k=v")
        if k == "p":
            kwargs["prob"] = float(v)
        elif k == "ms":
            kwargs["delay_s"] = INF if v.lower() == "inf" else float(v) / 1e3
        elif k == "match":
            kwargs["match"] = v
        elif k == "peer":
            kwargs["peer"] = v
        elif k == "count":
            kwargs["count"] = int(v)
        elif k == "after":
            kwargs["after"] = int(v)
        else:
            raise ValueError(
                f"unknown fault rule field {k!r} (fields: p, ms, match, peer, count, after)"
            )
    return FaultRule(site=site, action=action, **kwargs)


def parse_spec(seed: int, spec: str) -> FaultInjector:
    rules = [parse_rule(t) for t in spec.split(";") if t.strip()]
    if not rules:
        raise ValueError(f"fault spec {spec!r} contains no rules")
    return FaultInjector(seed, rules)


def parse_env(value: str) -> FaultInjector:
    """``RAY_TPU_FAULTS`` format: ``<seed>:<rule>[;<rule>...]``."""
    seed, sep, spec = value.partition(":")
    if not sep:
        raise ValueError(f"RAY_TPU_FAULTS={value!r} must be '<seed>:<rule>[;<rule>...]'")
    return parse_spec(int(seed), spec)


def _flightrec_fire(rule: FaultRule, name: str) -> None:
    """Record a fired rule in the flight recorder's ``faults`` ring and
    trigger a (throttled) postmortem dump, so a seeded chaos replay comes
    with the timeline before the injection. Never raises: the injected
    fault is the behaviour under test."""
    try:
        from ray_tpu_torch.util import flightrec

        if not flightrec.on():
            return
        what = f"{rule.site}.{rule.action}"
        flightrec.record("faults", what, rid=name or None, fired=rule.fired)
        flightrec.dump(f"fault:{what}")
    except Exception:  # noqa: BLE001 - an observability hook on the chaos path
        pass


# The process-wide injector. None = chaos off: seams check this one
# attribute and pay nothing else.
_ACTIVE: Optional[FaultInjector] = None

if GLOBAL_CONFIG.faults:
    _ACTIVE = parse_env(GLOBAL_CONFIG.faults)


def install(inj: FaultInjector) -> FaultInjector:
    global _ACTIVE
    _ACTIVE = inj
    return inj


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE
