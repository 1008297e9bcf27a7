"""OpenAI request → preprocessed request: chat rendering, tokenization
and the mapping of sampling and stop parameters.

Port of dynamo_tpu/frontend/preprocessor.py `Preprocessor`. The machine
with the card has no jinja2, so the reference's `DEFAULT_CHAT_TEMPLATE`
is rendered by `render_default_chat`, a plain function that gives
jinja2's output byte for byte:

    {% if tools %}system: You may call tools. Available tools: {{ tools | tojson }}
    To call one, reply with <tool_call>{"name": ..., "arguments": {...}}</tool_call>
    {% endif %}{% for message in messages %}{{ message['role'] }}: {% if
    message.get('tool_calls') %}{{ message['tool_calls'] | tojson }}{% else
    %}{{ message['content'] }}{% endif %}
    {% endfor %}assistant:

A card with a chat template of its own is refused until a template engine
is ported. The guided decoding constraint is the reference's `_guided`: a
required or named `tool_choice` over tools (the tool-call regex),
`response_format` (json_object, json_schema, structural_tag) and the
`guided_regex` / `guided_json` / `guided_choice` extensions, compiled to
the wire spec the worker lifts to token masks. Images are refused as the
reference refuses them for a model without a vision encoder. logit_bias,
logprobs and penalties are mapped as the reference maps them. A LoRA
adapter's entry (frontend/service.py) has a preprocessor of its own that
stamps the adapter's name into every request it builds.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.frontend.protocols import (
    ModelCard,
    SamplingOptions,
    StopConditions,
    make_preprocessed_request,
)
from dynamo_tpu_torch.frontend.tokenizer import Tokenizer, load_tokenizer
from dynamo_tpu_torch.guided.json_schema import (
    GENERIC_JSON,
    schema_to_regex,
    tool_call_regex,
)
from dynamo_tpu_torch.guided.regex_dfa import escape

_TOOLS_PREAMBLE = (
    "system: You may call tools. Available tools: {}\n"
    "To call one, reply with <tool_call>{{\"name\": ..., \"arguments\": {{...}}}}"
    "</tool_call>\n"
)


def tojson(obj: Any) -> str:
    """jinja2's `tojson` filter: json.dumps with sorted keys (ASCII
    escapes), then <, >, & and ' as \\u escapes."""
    return (json.dumps(obj, sort_keys=True)
            .replace("<", "\\u003c").replace(">", "\\u003e")
            .replace("&", "\\u0026").replace("'", "\\u0027"))


def render_default_chat(messages: List[Dict[str, Any]],
                        tools: Optional[List[Dict[str, Any]]] = None) -> str:
    """The reference's DEFAULT_CHAT_TEMPLATE as jinja2 renders it: a value
    prints as str() (None as "None", a missing key as ""), message
    content unescaped."""
    parts = [_TOOLS_PREAMBLE.format(tojson(tools))] if tools else []
    for m in messages:
        if not isinstance(m, dict):
            raise ValueError("each chat message must be an object")
        parts.append(f"{m['role']}: " if "role" in m else ": ")
        if m.get("tool_calls"):
            parts.append(tojson(m["tool_calls"]))
        elif "content" in m:
            parts.append(str(m["content"]))
        parts.append("\n")
    parts.append("assistant:")
    return "".join(parts)


class Preprocessor:
    def __init__(self, card: ModelCard, tokenizer: Optional[Tokenizer] = None,
                 adapter: Optional[str] = None):
        if card.chat_template:
            raise ValueError(
                f"model {card.name!r} brings a chat template of its own; the port "
                "renders only the default template (no template engine yet)")
        self.card = card
        self.tokenizer = tokenizer or load_tokenizer(card.tokenizer)
        self.adapter = adapter  # the LoRA adapter this entry serves (None: base)

    # -- prompt assembly ---------------------------------------------------
    def render_chat(self, messages: List[Dict[str, Any]],
                    tools: Optional[List[Dict[str, Any]]] = None) -> str:
        return render_default_chat(messages, tools)

    def tokenize_prompt(self, prompt: str, add_bos: bool = True) -> List[int]:
        ids = self.tokenizer.encode(prompt)
        bos = self.tokenizer.bos_id
        if add_bos and bos is not None and (not ids or ids[0] != bos):
            ids = [bos] + ids
        return ids

    # -- request mapping ---------------------------------------------------
    def _sampling(self, req: Dict[str, Any]) -> SamplingOptions:
        # completions: `logprobs: <top N>`; chat: `logprobs: true` and
        # `top_logprobs: <N>`; capped at OpenAI's 20
        lp = req.get("logprobs")
        if lp is True:
            lp = int(req.get("top_logprobs") or 0)
        elif lp is False:
            lp = None
        elif lp is not None:
            lp = int(lp)
        if lp is not None:
            lp = max(0, min(lp, 20))
        return SamplingOptions(
            # absent is 1.0 (sampled), as OpenAI's default; null is 0
            temperature=req.get("temperature", 1.0) or 0.0,
            top_p=req.get("top_p", 1.0) or 1.0,
            top_k=req.get("top_k", 0) or 0,
            seed=req.get("seed"),
            frequency_penalty=req.get("frequency_penalty", 0.0) or 0.0,
            presence_penalty=req.get("presence_penalty", 0.0) or 0.0,
            repetition_penalty=req.get("repetition_penalty", 1.0) or 1.0,
            logprobs=lp,
        )

    def _stop(self, req: Dict[str, Any], prompt_len: int) -> StopConditions:
        stop = req.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        max_tokens = req.get("max_tokens") or req.get("max_completion_tokens")
        if max_tokens is None:
            max_tokens = min(512, max(1, self.card.context_length - prompt_len))
        stop_ids = list(req.get("stop_token_ids") or [])
        eos = self.tokenizer.eos_id
        if eos is not None and eos not in stop_ids:
            stop_ids.append(eos)
        return StopConditions(
            max_tokens=int(max_tokens),
            stop_strings=list(stop),
            stop_ids=stop_ids,
            min_tokens=int(req.get("min_tokens") or 0),
            ignore_eos=bool(req.get("ignore_eos", False)),
        )

    _IMG_SENTINEL = "\x00<image>\x00"

    def _flatten_multimodal(self, messages, images_out: list):
        """Content-block messages → plain-text messages, an image sentinel
        per image; collects the decoded image bytes in order."""
        flat = []
        for m in messages:
            content = m.get("content")
            if not isinstance(content, list):
                flat.append(m)
                continue
            parts = []
            for b in content:
                t = b.get("type")
                if t in ("text", "input_text"):
                    parts.append(b.get("text", ""))
                elif t == "image_url":
                    url = (b.get("image_url") or {}).get("url", "")
                    if not url.startswith("data:") or "," not in url:
                        raise ValueError("image_url must be a data: URL with base64 "
                                         "payload (no egress from this deployment)")
                    try:
                        images_out.append(base64.b64decode(url.split(",", 1)[1]))
                    except ValueError as e:
                        raise ValueError(f"invalid base64 image payload: {e}")
                    parts.append(self._IMG_SENTINEL)
                else:
                    raise ValueError(f"unsupported content block type {t!r} "
                                     "(supported: text, image_url)")
            flat.append({**m, "content": "".join(parts)})
        return flat

    def preprocess_chat(self, req: Dict[str, Any]) -> Dict[str, Any]:
        tools = req.get("tools") or None
        if req.get("tool_choice") == "none":
            tools = None  # the model must not see or call tools
        images: list = []
        messages = self._flatten_multimodal(req.get("messages") or [], images)
        prompt = self.render_chat(messages, tools=tools)
        if images:
            if not self.card.vision:
                raise ValueError("model serves no vision encoder (no images)")
            raise ValueError("images need the encoder stage, which the port has "
                             "not ported yet (A.12)")
        ids = self.tokenize_prompt(prompt)
        self._check_context(len(ids))
        annotations: Dict[str, Any] = {"kind": "chat"}
        if tools:
            annotations["tools"] = True
        return self._request(req, ids, annotations, tools)

    def preprocess_completions(self, req: Dict[str, Any]) -> Dict[str, Any]:
        prompt = req.get("prompt") or ""
        if isinstance(prompt, list):  # token-id prompt passthrough
            ids = [int(t) for t in prompt]
        else:
            ids = self.tokenize_prompt(str(prompt))
        self._check_context(len(ids))
        return self._request(req, ids, {"kind": "completions"}, None)

    def _request(self, req, ids, annotations, tools) -> Dict[str, Any]:
        # the reference's order of checks: sampling, logit_bias, stop,
        # then the guided constraint
        sampling = self._sampling(req)
        logit_bias = self._logit_bias(req)
        stop = self._stop(req, len(ids))
        return make_preprocessed_request(
            model=req.get("model", self.card.name), token_ids=ids,
            sampling=sampling, stop=stop, annotations=annotations,
            logit_bias=logit_bias, guided=self._guided(req, tools),
            adapter=self.adapter)

    def _guided(self, req: Dict[str, Any],
                tools: Optional[List[Dict[str, Any]]]) -> Optional[Dict[str, Any]]:
        """The OpenAI constraint surfaces as the wire spec: tool_choice
        "required" or {"function": {"name": ...}} as the tool-call regex
        over the declared tools; response_format json_object, json_schema
        or structural_tag; the guided_regex / guided_json / guided_choice
        extensions."""
        tc = req.get("tool_choice")
        if tools and tc == "required":
            return {"kind": "regex", "pattern": tool_call_regex(tools)}
        if tools and isinstance(tc, dict):
            name = (tc.get("function") or {}).get("name")
            if name:
                return {"kind": "regex", "pattern": tool_call_regex(tools, name=name)}
        rf = req.get("response_format") or {}
        kind = rf.get("type")
        if kind == "json_object":
            return {"kind": "regex", "pattern": GENERIC_JSON}
        if kind == "json_schema":
            schema = (rf.get("json_schema") or {}).get("schema", rf.get("schema"))
            if schema is None:
                raise ValueError("response_format.json_schema needs a schema")
            return {"kind": "regex", "pattern": schema_to_regex(schema)}
        if kind == "structural_tag":
            structures = [
                {"begin": st.get("begin", ""), "end": st.get("end", ""),
                 "pattern": (schema_to_regex(st["schema"])
                             if st.get("schema") is not None
                             else st.get("pattern", GENERIC_JSON))}
                for st in rf.get("structures") or []]
            return {"kind": "structural", "triggers": rf.get("triggers") or [],
                    "structures": structures}
        if req.get("guided_regex"):
            return {"kind": "regex", "pattern": req["guided_regex"]}
        if req.get("guided_json") is not None:
            schema = req["guided_json"]
            if isinstance(schema, str):
                schema = json.loads(schema)
            return {"kind": "regex", "pattern": schema_to_regex(schema)}
        if req.get("guided_choice"):
            return {"kind": "regex", "pattern": "(" + "|".join(
                escape(str(c)) for c in req["guided_choice"]) + ")"}
        return None

    def _logit_bias(self, req: Dict[str, Any]):
        """OpenAI logit_bias {token_id_str: bias} → [[id, bias], ...]: ids
        checked against the vocabulary, biases clamped to ±100."""
        lb = req.get("logit_bias")
        if not lb:
            return None
        if not isinstance(lb, dict):
            raise ValueError("logit_bias must be an object of token_id -> bias")
        if len(lb) > 300:  # OpenAI caps the map size
            raise ValueError("logit_bias supports at most 300 entries")
        out = []
        vocab = self.tokenizer.vocab_size or (1 << 30)
        for k, v in lb.items():
            try:
                tok = int(k)
                b = float(v)
            except (TypeError, ValueError):
                raise ValueError(f"invalid logit_bias entry {k!r}: {v!r}")
            if not 0 <= tok < vocab:
                raise ValueError(f"logit_bias token id {tok} out of vocab")
            out.append([tok, max(-100.0, min(100.0, b))])
        return out

    def _check_context(self, prompt_len: int) -> None:
        if prompt_len >= self.card.context_length:
            raise ValueError(
                f"prompt length {prompt_len} exceeds model context length "
                f"{self.card.context_length}")
