"""Namespace → Component → Endpoint → Instance addressing model.

Port of dynamo_tpu/runtime/component.py: every servable unit is addressed
`namespace/component/endpoint`, and each live server of that endpoint is an
Instance with a unique instance_id plus the transport address where its
request-plane server listens. `to_dict` / `from_dict` keep the reference's
record layout, so both packages read each other's discovery records.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field, asdict
from enum import Enum
from typing import Any, Dict


class TransportKind(str, Enum):
    """Request-plane transport for an instance (reference TransportType,
    component.rs:73-79 — Nats or Tcp; we add InProc for tests)."""

    TCP = "tcp"
    INPROC = "inproc"


@dataclass(frozen=True)
class EndpointAddress:
    """Logical address of an endpoint: `ns/component/endpoint`."""

    namespace: str
    component: str
    endpoint: str

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.endpoint}"

    @classmethod
    def parse(cls, path: str) -> "EndpointAddress":
        ns, comp, ep = path.split("/", 2)
        return cls(ns, comp, ep)

    def __str__(self) -> str:
        return self.path


def new_instance_id() -> int:
    """Random 63-bit instance id (reference uses etcd lease ids)."""
    return secrets.randbits(63)


@dataclass
class Instance:
    """A live server of an endpoint (reference Instance, component.rs:107-115)."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int
    transport: TransportKind = TransportKind.TCP
    # host:port of the instance's request-plane server (TCP) or in-proc key
    address: str = ""
    # arbitrary worker metadata: model card, dp_size, kv event endpoint, ...
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def endpoint_address(self) -> EndpointAddress:
        return EndpointAddress(self.namespace, self.component, self.endpoint)

    @property
    def path(self) -> str:
        """Discovery key: services/{ns}/{component}/{endpoint}/{instance_id}
        (the reference uses `{endpoint}-{lease_id}`,
        docs/design-docs/distributed-runtime.md:62; we use a `/` delimiter so
        an endpoint name that prefixes another never collides in watches)."""
        return f"services/{self.namespace}/{self.component}/{self.endpoint}/{self.instance_id:x}"

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["transport"] = self.transport.value
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Instance":
        d = dict(d)
        d["transport"] = TransportKind(d.get("transport", "tcp"))
        return cls(**d)
