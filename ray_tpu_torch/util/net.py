"""Network helpers. Port of ``ray_tpu/util/net.py``.

:func:`local_ip` differs from the reference on purpose: it never probes
the network. The reference resolves the host name and, failing that,
``connect``s a UDP socket towards a public address to read the egress
interface; the port reads ``RAY_TPU_HOST_IP`` (the operator's address for
peers on other hosts) and otherwise serves on loopback, which reaches
every process of this host.
"""

from __future__ import annotations

import os
import socket


def local_ip() -> str:
    """The address this process's servers listen on and advertise:
    ``RAY_TPU_HOST_IP`` where it is set, else ``127.0.0.1``."""
    return os.environ.get("RAY_TPU_HOST_IP") or "127.0.0.1"


def free_port() -> int:
    """A TCP port that was free a moment ago (bound to port 0 and closed)."""
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port
