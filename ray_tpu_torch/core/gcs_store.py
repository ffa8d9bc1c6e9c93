"""Pluggable GCS metadata storage — the fault-tolerance substrate.
Port of ``ray_tpu/core/gcs_store.py``.

Reference parity: src/ray/gcs/store_client/ (InMemoryStoreClient
:32, RedisStoreClient :126 for GCS FT) and GcsTableStorage
(gcs_table_storage.h:200). Redesigned: a tiny table/key/value-bytes ABC with
an sqlite-WAL file backend instead of an external redis — a single head-local
(or NFS) file gives restart durability without another daemon; the interface
leaves room for a redis-compatible client later.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Iterator, Optional


class StoreClient:
    """ABC: durable (table, key) -> bytes."""

    def put(self, table: str, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, table: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, table: str, key: str) -> None:
        raise NotImplementedError

    def scan(self, table: str) -> Iterator[tuple]:
        """Yield (key, value) pairs."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStoreClient(StoreClient):
    """Default: no durability (reference: in_memory_store_client.h:32)."""

    def __init__(self):
        self._tables: dict[str, dict[str, bytes]] = {}

    def put(self, table, key, value):
        self._tables.setdefault(table, {})[key] = value

    def get(self, table, key):
        return self._tables.get(table, {}).get(key)

    def delete(self, table, key):
        self._tables.get(table, {}).pop(key, None)

    def scan(self, table):
        yield from list(self._tables.get(table, {}).items())


class SqliteStoreClient(StoreClient):
    """File-backed store in WAL mode; one writer (the GCS loop thread).

    Durable across GCS restarts: pointing a new GcsServer at the same path
    reloads every table (the RedisStoreClient role, without redis).
    """

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " tbl TEXT NOT NULL, key TEXT NOT NULL, value BLOB NOT NULL,"
            " PRIMARY KEY (tbl, key))"
        )
        self._db.commit()

    def put(self, table, key, value):
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO kv (tbl, key, value) VALUES (?,?,?)",
                (table, key, sqlite3.Binary(bytes(value))),
            )
            self._db.commit()

    def get(self, table, key):
        with self._lock:
            row = self._db.execute(
                "SELECT value FROM kv WHERE tbl=? AND key=?", (table, key)
            ).fetchone()
        return None if row is None else bytes(row[0])

    def delete(self, table, key):
        with self._lock:
            self._db.execute(
                "DELETE FROM kv WHERE tbl=? AND key=?", (table, key)
            )
            self._db.commit()

    def scan(self, table):
        with self._lock:
            rows = self._db.execute(
                "SELECT key, value FROM kv WHERE tbl=?", (table,)
            ).fetchall()
        for k, v in rows:
            yield k, bytes(v)

    def close(self):
        with self._lock:
            try:
                self._db.close()
            except Exception:  # raylint: disable=RL006 -- sqlite close during process teardown; data already flushed per-write
                pass


def make_store(path: str | None) -> StoreClient:
    return SqliteStoreClient(path) if path else InMemoryStoreClient()
