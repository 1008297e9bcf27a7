"""Pluggable service discovery.

Port of dynamo_tpu/runtime/discovery.py, the `mem` backend (in-process,
shared across runtimes in one process) and the `file` backend (a shared
directory of JSON records with mtime-heartbeat leases: multi-process on
one host). The records are the reference's, so a reference process and a
port process on one root discover each other. The etcd and kubernetes
backends are not ported yet.

Subscribers of `watch` receive (put | delete, Instance) events, with an
initial put replay of existing instances.
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import AsyncIterator, Dict, List, Optional

from dynamo_tpu_torch.runtime.component import Instance


@dataclass
class DiscoveryEvent:
    kind: str  # "put" | "delete"
    instance: Instance


class DiscoveryBackend:
    """Interface: register/unregister instances, list, watch a prefix."""

    async def register(self, instance: Instance) -> None:
        raise NotImplementedError

    async def unregister(self, instance: Instance) -> None:
        raise NotImplementedError

    async def list_instances(self, prefix: str = "") -> List[Instance]:
        raise NotImplementedError

    async def watch(self, prefix: str = "") -> AsyncIterator[DiscoveryEvent]:
        raise NotImplementedError
        yield  # pragma: no cover

    async def close(self) -> None:
        pass

    # liveness: backends with leases refresh them here (no-op for mem)
    async def heartbeat(self) -> None:
        pass


async def poll_diff_watch(scan, poll_interval: float, on_error=None):
    """Shared poll-based watch: diff successive scans into put/delete
    events (used by the file and kubernetes backends). `scan` is an async
    callable returning {path: Instance}."""
    known: Dict[str, dict] = {}
    while True:
        try:
            current = await scan()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if on_error is not None:
                on_error(e)
            await asyncio.sleep(poll_interval)
            continue
        for path, inst in current.items():
            rec = inst.to_dict()
            if known.get(path) != rec:  # new or changed (metadata/address)
                known[path] = rec
                yield DiscoveryEvent("put", inst)
        for path in list(known):
            if path not in current:
                rec = known.pop(path)
                yield DiscoveryEvent("delete", Instance.from_dict(rec))
        await asyncio.sleep(poll_interval)


class MemDiscovery(DiscoveryBackend):
    """In-process discovery; all MemDiscovery() instances created with the
    same `realm` share one registry, so N workers + a frontend in one process
    (or one pytest) discover each other."""

    _realms: Dict[str, "_MemRealm"] = {}

    def __init__(self, realm: str = "default"):
        self._realm = MemDiscovery._realms.setdefault(realm, _MemRealm())

    async def register(self, instance: Instance) -> None:
        await self._realm.put(instance)

    async def unregister(self, instance: Instance) -> None:
        await self._realm.delete(instance)

    async def list_instances(self, prefix: str = "") -> List[Instance]:
        return [i for p, i in self._realm.store.items() if p.startswith(prefix or "services/")]

    async def watch(self, prefix: str = "") -> AsyncIterator[DiscoveryEvent]:
        queue: asyncio.Queue = asyncio.Queue()
        prefix = prefix or "services/"
        self._realm.watchers.append((prefix, queue))
        try:
            for inst in await self.list_instances(prefix):
                yield DiscoveryEvent("put", inst)
            while True:
                ev = await queue.get()
                yield ev
        finally:
            self._realm.watchers.remove((prefix, queue))

    @classmethod
    def reset(cls, realm: Optional[str] = None) -> None:
        """Test helper: drop realm state."""
        if realm is None:
            cls._realms.clear()
        else:
            cls._realms.pop(realm, None)


class _MemRealm:
    def __init__(self):
        self.store: Dict[str, Instance] = {}
        self.watchers: List[tuple[str, asyncio.Queue]] = []

    async def put(self, instance: Instance) -> None:
        self.store[instance.path] = instance
        self._notify(DiscoveryEvent("put", instance))

    async def delete(self, instance: Instance) -> None:
        self.store.pop(instance.path, None)
        self._notify(DiscoveryEvent("delete", instance))

    def _notify(self, ev: DiscoveryEvent) -> None:
        for prefix, q in self.watchers:
            if ev.instance.path.startswith(prefix):
                q.put_nowait(ev)


class FileDiscovery(DiscoveryBackend):
    """Directory-backed discovery for multi-process single-host topologies.

    Each instance is one JSON file at `{root}/{instance.path}.json`. Liveness
    = file mtime refreshed by `heartbeat()`; records older than `lease_ttl`
    seconds are treated as dead (the file analog of etcd lease expiry,
    docs/design-docs/distributed-runtime.md:55). Watching is poll-based.
    """

    def __init__(self, root: str, lease_ttl: float = 10.0, poll_interval: float = 0.25):
        self.root = Path(root)
        self.lease_ttl = lease_ttl
        self.poll_interval = poll_interval
        self._mine: Dict[str, Instance] = {}

    def _file(self, instance_path: str) -> Path:
        return self.root / (instance_path + ".json")

    async def register(self, instance: Instance) -> None:
        f = self._file(instance.path)
        f.parent.mkdir(parents=True, exist_ok=True)
        tmp = f.with_suffix(".tmp")
        tmp.write_text(json.dumps(instance.to_dict()))
        os.replace(tmp, f)
        self._mine[instance.path] = instance

    async def unregister(self, instance: Instance) -> None:
        self._mine.pop(instance.path, None)
        try:
            self._file(instance.path).unlink()
        except FileNotFoundError:
            pass

    async def heartbeat(self) -> None:
        now = time.time()
        for path in list(self._mine):
            try:
                os.utime(self._file(path), (now, now))
            except FileNotFoundError:
                # lease lost (file removed externally): re-register
                await self.register(self._mine[path])

    def _scan(self, prefix: str) -> Dict[str, Instance]:
        out: Dict[str, Instance] = {}
        base = self.root
        if not base.exists():
            return out
        cutoff = time.time() - self.lease_ttl
        for f in base.rglob("*.json"):
            rel = str(f.relative_to(base))[: -len(".json")]
            if prefix and not rel.startswith(prefix):
                continue
            try:
                if f.stat().st_mtime < cutoff:
                    continue
                out[rel] = Instance.from_dict(json.loads(f.read_text()))
            except (OSError, ValueError):
                continue
        return out

    async def list_instances(self, prefix: str = "") -> List[Instance]:
        return list(self._scan(prefix or "services/").values())

    async def watch(self, prefix: str = "") -> AsyncIterator[DiscoveryEvent]:
        import logging

        prefix = prefix or "services/"
        log = logging.getLogger("dynamo_tpu_torch.runtime.discovery")

        async def scan():
            return self._scan(prefix)

        async for ev in poll_diff_watch(
            scan, self.poll_interval,
            on_error=lambda e: log.warning("file discovery scan failed (%s); retrying", e),
        ):
            yield ev


def make_discovery(backend: Optional[str] = None, **kw) -> DiscoveryBackend:
    """Select a backend, env-first (DYN_DISCOVERY_BACKEND): "mem" or
    "file" (root from `root` or DYN_DISCOVERY_FILE_ROOT)."""
    backend = backend or os.environ.get("DYN_DISCOVERY_BACKEND", "mem")
    if backend == "mem":
        return MemDiscovery(realm=kw.get("realm", "default"))
    if backend == "file":
        root = kw.get("root") or os.environ.get(
            "DYN_DISCOVERY_FILE_ROOT",
            os.path.join(tempfile.gettempdir(), "dynamo_tpu_discovery"))
        return FileDiscovery(root, lease_ttl=float(kw.get("lease_ttl", 10.0)))
    raise ValueError(f"unknown discovery backend {backend!r}")
