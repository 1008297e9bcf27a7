"""Backend operator: incremental detokenization and stop conditions.

Port of dynamo_tpu/frontend/backend.py `_longest_partial_suffix`,
`StopChecker` and `BackendOperator`. Sits between migration and the
router: turns the engine's token-id stream into text deltas and enforces
stop strings, stop ids and max_tokens, holding back text that may be the
start of a stop string so that stop text never reaches the client. An
item's logprob report is cut to the tokens that reach the client.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Dict, List

from dynamo_tpu_torch.frontend.tokenizer import IncrementalDetokenizer, Tokenizer
from dynamo_tpu_torch.runtime.context import Context


def _longest_partial_suffix(text: str, stops: List[str]) -> int:
    """Length of the longest suffix of `text` that is a proper prefix of
    any stop string (that much text must be held back)."""
    best = 0
    for s in stops:
        for k in range(min(len(s) - 1, len(text)), 0, -1):
            if text.endswith(s[:k]):
                best = max(best, k)
                break
    return best


class StopChecker:
    """Counts generated tokens and decides when and how to stop."""

    def __init__(self, stop: Dict[str, Any]):
        self.max_tokens = int(stop.get("max_tokens", 512))
        # "" would match at index 0 of everything: drop degenerate entries
        self.stop_strings = [s for s in (stop.get("stop_strings") or []) if s]
        self.stop_ids = set(stop.get("stop_ids") or [])
        self.min_tokens = int(stop.get("min_tokens", 0))
        self.ignore_eos = bool(stop.get("ignore_eos", False))
        self.n_tokens = 0

    def check_tokens(self, token_ids: List[int]) -> tuple:
        """(finish_reason or None, tokens to emit): a stop id is dropped;
        max_tokens truncates the item."""
        for i, t in enumerate(token_ids):
            self.n_tokens += 1
            if (not self.ignore_eos and t in self.stop_ids
                    and self.n_tokens > self.min_tokens):
                return "stop", token_ids[:i]
            if self.n_tokens >= self.max_tokens:
                return "length", token_ids[:i + 1]
        return None, token_ids

    def find_stop_string(self, text: str):
        """(index, matched string) of the earliest stop-string hit in
        `text`, or (-1, None)."""
        best, match = -1, None
        for s in self.stop_strings:
            i = text.find(s)
            if i >= 0 and (best < 0 or i < best):
                best, match = i, s
        return best, match


class BackendOperator:
    """Engine wrapper: downstream yields {"token_ids", "finish_reason",
    ...}; this yields {"text", "token_ids", "finish_reason", ...} with the
    stops enforced."""

    def __init__(self, tokenizer: Tokenizer, downstream):
        self.tokenizer = tokenizer
        self.downstream = downstream

    async def generate(self, request: Dict[str, Any], context: Context) -> AsyncIterator[Any]:
        detok = IncrementalDetokenizer(self.tokenizer)
        checker = StopChecker(request.get("stop") or {})
        pending = ""  # text held back by a partial stop-string match

        async for item in self.downstream.generate(request, context):
            token_ids = item.get("token_ids") or []
            finish = item.get("finish_reason")

            token_stop, emit_ids = checker.check_tokens(token_ids)
            if item.get("logprobs") and len(emit_ids) != len(token_ids):
                # keep the report aligned with the tokens that reach the
                # client (stop or length may cut the item)
                item = dict(item)
                item["logprobs"] = item["logprobs"][:len(emit_ids)]
            pending += detok.push(emit_ids)

            if checker.stop_strings:
                cut, matched = checker.find_stop_string(pending)
                if cut >= 0:
                    yield {
                        "text": pending[:cut],
                        "token_ids": emit_ids,
                        "finish_reason": "stop",
                        "stop_sequence": matched,  # which client stop fired
                        **_passthrough(item),
                    }
                    context.stop_generating()
                    return
                hold = _longest_partial_suffix(pending, checker.stop_strings)
            else:
                hold = 0

            emit_now = pending[:len(pending) - hold] if hold else pending
            pending = pending[len(pending) - hold:] if hold else ""

            finish = token_stop or finish
            if finish:
                tail = emit_now + (detok.finish() if token_stop is None else "")
                yield {
                    "text": tail if token_stop is None else emit_now,
                    "token_ids": emit_ids,
                    "finish_reason": finish,
                    **_passthrough(item),
                }
                if finish in ("stop", "length"):
                    context.stop_generating()
                return

            if emit_now or token_ids:
                yield {
                    "text": emit_now,
                    "token_ids": emit_ids,
                    "finish_reason": None,
                    **_passthrough(item),
                }

        # the stream ended without a finish
        yield {"text": pending + detok.finish(), "token_ids": [], "finish_reason": "stop"}


def _passthrough(item: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in item.items()
            if k not in ("token_ids", "finish_reason", "text")}
