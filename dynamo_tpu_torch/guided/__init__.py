"""Guided decoding: constrained generation via byte-level DFAs.

Copy of dynamo_tpu/guided (numpy only; the imports changed, and the
token lifter keeps the byte tokenizer's branch, the only tokenizer the
port reads):

- constraints compile on the frontend to a compact byte-level DFA
  (regex subset / JSON schema -> regex / structural-tag composite);
- the worker lifts the byte DFA to per-state token masks against its
  tokenizer (lazy per-state rows);
- the engine samples with the mask applied to the logits on the device
  (a [B, V] input, or the dense tables of device_table.py gathered in
  the decode loop), advancing each sequence's DFA state per accepted
  token on the host.

Wire format (PreprocessedRequest["guided"]):
  {"kind": "regex", "pattern": <pattern>}
  {"kind": "structural", "triggers": [...],
   "structures": [{"begin": s, "pattern": p, "end": s}, ...]}
"""

from dynamo_tpu_torch.guided.regex_dfa import ByteDFA, compile_regex
from dynamo_tpu_torch.guided.json_schema import schema_to_regex, GENERIC_JSON
from dynamo_tpu_torch.guided.token_mask import GuidedMatcher, TokenLifter
from dynamo_tpu_torch.guided.structural import compile_structural

__all__ = [
    "ByteDFA",
    "compile_regex",
    "schema_to_regex",
    "GENERIC_JSON",
    "GuidedMatcher",
    "TokenLifter",
    "compile_structural",
]
