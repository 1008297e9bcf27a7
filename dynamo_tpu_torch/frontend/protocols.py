"""Frontend protocols: the model card and the preprocessed request.

Port of dynamo_tpu/frontend/protocols.py `ModelCard`, `SamplingOptions`,
`StopConditions` and `make_preprocessed_request`. A worker publishes its
card in its instance metadata under "model_card"; the frontend's model
watcher builds a serving chain per discovered card, and its preprocessor
turns each OpenAI request into the dict that `make_preprocessed_request`
builds (kept a plain dict on the wire).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ModelCard:
    name: str
    tokenizer: str = "byte"  # 'byte' or path to tokenizer.json
    chat_template: Optional[str] = None  # jinja2; None → default template
    context_length: int = 8192
    kv_block_size: int = 16
    model_type: str = "completions"  # completions | embeddings
    adapters: List[str] = field(default_factory=list)  # served LoRA names
    # multimodal: {"image_token_id", "n_image_tokens", "image_size"}
    vision: Optional[Dict[str, Any]] = None
    runtime_config: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelCard":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


@dataclass
class SamplingOptions:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    seed: Optional[int] = None
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0  # HF-style multiplicative; 1.0 = off
    logprobs: Optional[int] = None  # top-N logprob report (None = off)


@dataclass
class StopConditions:
    max_tokens: int = 512
    stop_strings: List[str] = field(default_factory=list)
    stop_ids: List[int] = field(default_factory=list)
    min_tokens: int = 0
    ignore_eos: bool = False


def make_preprocessed_request(
    model: str,
    token_ids: List[int],
    sampling: SamplingOptions,
    stop: StopConditions,
    annotations: Optional[Dict[str, Any]] = None,
    logit_bias: Optional[List] = None,
    guided: Optional[Dict[str, Any]] = None,
    adapter: Optional[str] = None,
) -> Dict[str, Any]:
    out = {
        "model": model,
        "token_ids": token_ids,
        "sampling": asdict(sampling),
        "stop": asdict(stop),
        "annotations": annotations or {},
    }
    if logit_bias:
        # [[token_id, bias], ...]: additive sampling bias (OpenAI logit_bias)
        out["logit_bias"] = logit_bias
    if guided:
        # the constraint spec the worker lifts to token masks
        # (dynamo_tpu_torch/guided): {"kind": "regex"|"structural", ...}
        out["guided"] = guided
    if adapter:
        # the LoRA adapter the worker applies (its slot resolved there)
        out["adapter"] = adapter
    return out
