"""Operator chains over AsyncEngines.

Port of dynamo_tpu/runtime/pipeline.py: every pipeline stage is an
AsyncEngine wrapping an inner one, so a chain is an ordered list of stage
specs (name, factory, enabled). `build_chain` folds them right to left
onto a sink engine and returns a `Chain` that serves from the head,
exposes the built stages by name (the frontend's model watcher activates
the PrefillRouter stage when a prefill pool appears) and tears them down
head first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

from dynamo_tpu_torch.runtime.engine import AsyncEngine


@dataclass
class StageSpec:
    """One prospective operator in a chain: factory(inner, ctx) wraps the
    downstream engine; the stage is skipped when enabled(ctx) is False."""

    name: str
    factory: Callable[[AsyncEngine, Any], AsyncEngine]
    enabled: Callable[[Any], bool] = lambda ctx: True


class Chain:
    """A built operator chain. `generate` enters at the head (the first
    enabled stage); `stages` maps name → built engine."""

    def __init__(self, head: AsyncEngine, stages: Dict[str, AsyncEngine],
                 order: List[str], extra_teardown: Any = None,
                 sink: Optional[AsyncEngine] = None):
        self.head = head
        self.stages = stages
        self.order = order  # head-first stage names
        self.sink = sink  # the egress engine the specs folded onto
        self._extra_teardown = extra_teardown

    async def generate(self, request: Any, context: Any) -> AsyncIterator[Any]:
        async for item in self.head.generate(request, context):
            yield item

    def get(self, name: str) -> Optional[AsyncEngine]:
        return self.stages.get(name)

    async def teardown(self) -> None:
        """Close stages head first (upstream stops feeding downstream),
        then the sink's teardown. A stage takes part by exposing an async
        `stop` or `close`."""
        for name in self.order:
            stage = self.stages[name]
            closer = getattr(stage, "stop", None) or getattr(stage, "close", None)
            if closer is not None:
                await closer()
        if self._extra_teardown is not None:
            await self._extra_teardown()


def build_chain(specs: List[StageSpec], sink: AsyncEngine, ctx: Any,
                sink_teardown: Any = None) -> Chain:
    """Fold stage specs (listed head first) onto `sink`; `sink_teardown`
    is an async callable closing sink-owned resources, run last."""
    built: Dict[str, AsyncEngine] = {}
    order: List[str] = []
    inner = sink
    for spec in reversed(specs):
        if not spec.enabled(ctx):
            continue
        inner = spec.factory(inner, ctx)
        built[spec.name] = inner
        order.insert(0, spec.name)
    return Chain(inner, built, order, extra_teardown=sink_teardown, sink=sink)
