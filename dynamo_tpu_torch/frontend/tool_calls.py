"""Tool-call parsing: generated text → OpenAI `tool_calls`.

Parity with the reference's tool-call parser registry
(lib/parsers/src/tool_calling/: hermes, llama3_json, mistral, pythonic,
plain-json parsers selected per model), feeding the chat completion
response's `message.tool_calls` and `finish_reason: "tool_calls"`.

Formats:
- hermes:      <tool_call>{"name": ..., "arguments": {...}}</tool_call>
- mistral:     [TOOL_CALLS] [{"name": ..., "arguments": {...}}, ...]
- llama3_json: a bare JSON object {"name": ..., "parameters": {...}}
               (optionally after <|python_tag|>)
- json:        a bare JSON array of {"name", "arguments"} objects
- auto:        try each in the order above

Returns (content_text, tool_calls) — content is the text outside the tool
markup (normally empty when the model emits a call).
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Dict, List, Optional, Tuple

_HERMES_RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.DOTALL)
_MISTRAL_RE = re.compile(r"\[TOOL_CALLS\]\s*(\[.*\])", re.DOTALL)
_PYTHON_TAG = "<|python_tag|>"


def _mk_call(name: str, arguments: Any) -> Dict[str, Any]:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments or {})
    return {
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def _from_obj(obj: Any, strict: bool = False) -> Optional[Dict[str, Any]]:
    """strict=True additionally requires an arguments/parameters key — used
    by the bare-JSON parsers so an ordinary JSON answer that happens to
    contain a 'name' field (e.g. a contact record) is not destroyed by
    being misread as a call."""
    if not isinstance(obj, dict) or "name" not in obj:
        return None
    if strict and not ("arguments" in obj or "parameters" in obj):
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    return _mk_call(str(obj["name"]), args)


def _parse_hermes(text: str):
    calls = []
    for m in _HERMES_RE.finditer(text):
        try:
            call = _from_obj(json.loads(m.group(1)))
        except ValueError:
            return None
        if call is None:
            return None
        calls.append(call)
    if not calls:
        return None
    return _HERMES_RE.sub("", text).strip(), calls


def _parse_mistral(text: str):
    m = _MISTRAL_RE.search(text)
    if not m:
        return None
    try:
        arr = json.loads(m.group(1))
    except ValueError:
        return None
    calls = [_from_obj(o) for o in arr] if isinstance(arr, list) else []
    if not calls or any(c is None for c in calls):
        return None
    return text[: m.start()].strip(), calls


def _parse_llama3_json(text: str):
    t = text.strip()
    prefix = ""
    if _PYTHON_TAG in t:
        prefix, _, t = t.partition(_PYTHON_TAG)
        t = t.strip()
    if not (t.startswith("{") and t.endswith("}")):
        return None
    try:
        call = _from_obj(json.loads(t), strict=True)
    except ValueError:
        return None
    if call is None:
        return None
    return prefix.strip(), [call]


def _parse_json_array(text: str):
    t = text.strip()
    if not (t.startswith("[") and t.endswith("]")):
        return None
    try:
        arr = json.loads(t)
    except ValueError:
        return None
    if not isinstance(arr, list) or not arr:
        return None
    calls = [_from_obj(o, strict=True) for o in arr]
    if any(c is None for c in calls):
        return None
    return "", calls


_PARSERS = {
    "hermes": _parse_hermes,
    "mistral": _parse_mistral,
    "llama3_json": _parse_llama3_json,
    "json": _parse_json_array,
}


def parse_tool_calls(
    text: str, fmt: str = "auto"
) -> Tuple[str, Optional[List[Dict[str, Any]]]]:
    """Extract tool calls from generated text. Returns (content,
    tool_calls); tool_calls is None when the text contains none (content is
    then the original text untouched)."""
    parsers = _PARSERS.values() if fmt == "auto" else [_PARSERS[fmt]]
    for p in parsers:
        out = p(text)
        if out is not None:
            return out
    return text, None
