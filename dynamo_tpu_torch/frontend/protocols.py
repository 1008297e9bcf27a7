"""Frontend protocols: the model card.

Port of `ModelCard` from dynamo_tpu/frontend/protocols.py, which a worker
publishes in its instance metadata under "model_card"; a frontend's model
watcher builds a serving pipeline per discovered card. The rest of the
frontend (HTTP service, preprocessor, migration) is not ported yet.
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
