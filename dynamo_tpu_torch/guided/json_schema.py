"""JSON Schema → regex pattern (for the byte-DFA compiler).

The outlines-style reduction: a (non-recursive) JSON schema induces a
regular language once array/object sizes are bounded and generation is
pinned to a canonical surface form (minimal whitespace: one optional
space after ':' and ','). Supported keywords: type (string, integer,
number, boolean, null, object, array), enum, const, properties /
required / additionalProperties:false, items, minItems/maxItems,
minLength/maxLength/pattern for strings, minimum/maximum sign hints,
anyOf/oneOf, $ref into $defs/definitions. Recursive $refs raise (a
pushdown language — not expressible as a DFA; the reference's guided
backends bound or reject these too).

Empty schema / {"type": "object"} without properties compile to a
GENERIC depth-bounded JSON value grammar.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.guided.regex_dfa import escape

WS = "[ ]?"  # canonical optional single space
STRING_CHAR = '([^"\\\\\\x00-\\x1f]|\\\\(["\\\\/bfnrt]|u[0-9a-fA-F]{4}))'
STRING = f'"{STRING_CHAR}*"'
INTEGER = "-?(0|[1-9][0-9]*)"
NUMBER = "-?(0|[1-9][0-9]*)(\\.[0-9]+)?([eE][+-]?[0-9]+)?"
BOOLEAN = "(true|false)"
NULL = "null"

# depth-bounded generic JSON value (response_format: json_object).
# Unbounded member/element counts on purpose: bounded {0,n} repetition
# duplicates the whole item NFA n times PER NESTING LEVEL and explodes
# the DFA; `*` costs one loop block.
_GENERIC_DEPTH = 3


def _generic_value(depth: int) -> str:
    prims = f"({STRING}|{NUMBER}|{BOOLEAN}|{NULL})"
    if depth <= 0:
        return prims
    v = _generic_value(depth - 1)
    obj = f'(\\{{{WS}\\}}|\\{{{WS}{STRING}{WS}:{WS}{v}({WS},{WS}{STRING}{WS}:{WS}{v})*{WS}\\}})'
    arr = f"(\\[{WS}\\]|\\[{WS}{v}({WS},{WS}{v})*{WS}\\])"
    return f"({prims}|{obj}|{arr})"


def _generic_object(depth: int = _GENERIC_DEPTH) -> str:
    v = _generic_value(depth - 1)
    return f'(\\{{{WS}\\}}|\\{{{WS}{STRING}{WS}:{WS}{v}({WS},{WS}{STRING}{WS}:{WS}{v})*{WS}\\}})'


GENERIC_JSON = _generic_object()


class SchemaError(ValueError):
    pass


def schema_to_regex(schema: Any, max_depth: int = 32) -> str:
    """Compile a JSON schema dict (or bool) to a pattern string."""
    return _compile(schema, schema, max_depth)


def _compile(schema: Any, root: Any, depth: int) -> str:
    if depth <= 0:
        raise SchemaError("schema nesting too deep (recursive $ref?)")
    if schema is True or schema == {}:
        return _generic_value(_GENERIC_DEPTH)
    if schema is False:
        raise SchemaError("schema `false` admits nothing")
    if not isinstance(schema, dict):
        raise SchemaError(f"bad schema node {schema!r}")

    if "$ref" in schema:
        return _compile(_resolve_ref(schema["$ref"], root), root, depth - 1)
    if "const" in schema:
        return escape(json.dumps(schema["const"], separators=(",", ":")))
    if "enum" in schema:
        opts = [
            escape(json.dumps(v, separators=(",", ":"))) for v in schema["enum"]
        ]
        if not opts:
            raise SchemaError("empty enum")
        return "(" + "|".join(opts) + ")"
    for key in ("anyOf", "oneOf"):
        if key in schema:
            return (
                "("
                + "|".join(_compile(s, root, depth - 1) for s in schema[key])
                + ")"
            )
    if "allOf" in schema:
        merged: Dict[str, Any] = {}
        for part in schema["allOf"]:
            if "$ref" in part:
                part = _resolve_ref(part["$ref"], root)
            if not isinstance(part, dict):
                raise SchemaError("allOf parts must be objects")
            for k, v in part.items():
                if k == "properties":
                    merged.setdefault("properties", {}).update(v)
                elif k == "required":
                    merged["required"] = list(
                        dict.fromkeys(merged.get("required", []) + v)
                    )
                else:
                    merged[k] = v
        merged.update({k: v for k, v in schema.items() if k != "allOf"})
        return _compile(merged, root, depth - 1)

    t = schema.get("type")
    if isinstance(t, list):
        return "(" + "|".join(
            _compile({**schema, "type": one}, root, depth - 1) for one in t
        ) + ")"
    if t == "string":
        return _string(schema)
    if t == "integer":
        return INTEGER
    if t == "number":
        return NUMBER
    if t == "boolean":
        return BOOLEAN
    if t == "null":
        return NULL
    if t == "array":
        return _array(schema, root, depth)
    if t == "object" or "properties" in schema:
        return _object(schema, root, depth)
    if t is None:
        return _generic_value(_GENERIC_DEPTH)
    raise SchemaError(f"unsupported type {t!r}")


def _resolve_ref(ref: str, root: Any):
    if not ref.startswith("#/"):
        raise SchemaError(f"only local $refs supported, got {ref!r}")
    node = root
    for part in ref[2:].split("/"):
        part = part.replace("~1", "/").replace("~0", "~")
        if not isinstance(node, dict) or part not in node:
            raise SchemaError(f"unresolvable $ref {ref!r}")
        node = node[part]
    return node


def _string(schema: Dict[str, Any]) -> str:
    if "pattern" in schema:
        pat = schema["pattern"]
        if pat.startswith("^"):
            pat = pat[1:]
        if pat.endswith("$") and not pat.endswith("\\$"):
            pat = pat[:-1]
        _check_string_pattern(pat)
        return f'"({pat})"'
    lo = schema.get("minLength")
    hi = schema.get("maxLength")
    if lo is None and hi is None:
        return STRING
    lo = int(lo or 0)
    rep = f"{{{lo},{int(hi)}}}" if hi is not None else f"{{{lo},}}"
    return f'"{STRING_CHAR}{rep}"'


def _check_string_pattern(pat: str) -> None:
    """The user pattern is embedded verbatim inside '"(pat)"' at the JSON
    TEXT level, with no escaping translation — so a pattern able to emit
    a raw '"' would let generation escape the string context entirely,
    and a bare '\\' or control byte would force output that is not valid
    JSON. Enforce the restriction exactly: compile the pattern to its
    byte DFA and reject if any transition accepts an offending byte.
    (Schema `pattern` semantics apply to the DECODED value; supporting
    those bytes would need a JSON-escape-transducing compile.)"""
    from dynamo_tpu_torch.guided.regex_dfa import RegexError, compile_regex

    try:
        dfa = compile_regex(pat)
    except RegexError as e:
        raise SchemaError(f"unsupported string pattern {pat!r}: {e}") from e
    bad = [0x22, 0x5C] + list(range(0x20))
    if (dfa.trans[:, bad] >= 0).any():
        raise SchemaError(
            f"string pattern {pat!r} can match '\"', '\\' or a control "
            "character, which cannot be embedded in a JSON string "
            "constraint without escape translation"
        )


def _array(schema: Dict[str, Any], root: Any, depth: int) -> str:
    item = _compile(schema.get("items", True), root, depth - 1)
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")
    if hi is not None and int(hi) == 0:
        return f"\\[{WS}\\]"
    # n items = first item + (n-1) comma-items
    tail_lo = max(0, lo - 1)
    tail = f"({WS},{WS}{item})"
    tail_rep = (
        f"{tail}{{{tail_lo},{int(hi) - 1}}}" if hi is not None
        else (f"{tail}{{{tail_lo},}}" if tail_lo else f"{tail}*")
    )
    body = f"{item}{tail_rep}"
    if lo == 0:
        return f"(\\[{WS}\\]|\\[{WS}{body}{WS}\\])"
    return f"\\[{WS}{body}{WS}\\]"


_MAX_OPTIONAL = 8


def _object(schema: Dict[str, Any], root: Any, depth: int) -> str:
    props: Dict[str, Any] = schema.get("properties") or {}
    if not props:
        if schema.get("additionalProperties") is False:
            return f"\\{{{WS}\\}}"
        return _generic_object()
    required = set(schema.get("required") or [])
    items: List[tuple] = []  # (pattern, required)
    n_opt = 0
    for key, sub in props.items():
        pat = f'"{escape(key)}"{WS}:{WS}{_compile(sub, root, depth - 1)}'
        req = key in required
        if not req:
            n_opt += 1
        items.append((pat, req))
    if n_opt > _MAX_OPTIONAL:
        raise SchemaError(
            f"{n_opt} optional properties — the ordered-optional encoding "
            f"blows up past {_MAX_OPTIONAL}; mark more properties required"
        )

    # rest(i, first): properties i.. with `first` = nothing emitted yet.
    def rest(i: int, first: bool) -> str:
        if i == len(items):
            return ""
        pat, req = items[i]
        lead = "" if first else f"{WS},{WS}"
        with_it = f"{lead}{pat}{rest(i + 1, False)}"
        if req:
            return with_it
        without = rest(i + 1, first)
        return f"(({with_it})|({without}))" if without else f"({with_it})?"

    body = rest(0, True)
    if not required:
        return f"(\\{{{WS}\\}}|\\{{{WS}{body}{WS}\\}})"
    return f"\\{{{WS}{body}{WS}\\}}"


def tool_call_regex(tools: List[Dict[str, Any]],
                    name: Optional[str] = None) -> str:
    """Hermes-format tool-call pattern for `tool_choice` enforcement:
    <tool_call>{"name": ..., "arguments": {...}}</tool_call>, one or more
    calls, each constrained to a declared tool's parameter schema (or to
    the single named tool). Matches what the default chat template
    instructs and what frontend/tool_calls.py parses."""
    alts = []
    for t in tools:
        fn = t.get("function", t)
        if name is not None and fn.get("name") != name:
            continue
        call_schema = {
            "type": "object",
            "properties": {
                "name": {"const": fn.get("name", "")},
                "arguments": fn.get("parameters") or {"type": "object"},
            },
            "required": ["name", "arguments"],
            "additionalProperties": False,
        }
        alts.append(schema_to_regex(call_schema))
    if not alts:
        raise SchemaError(
            f"tool_choice names unknown function {name!r}"
            if name else "tool_choice requires non-empty tools"
        )
    one = "(" + "|".join(alts) + ")"
    call = f"<tool_call>{WS}{one}{WS}</tool_call>"
    return f"{call}({WS}{call})*"
