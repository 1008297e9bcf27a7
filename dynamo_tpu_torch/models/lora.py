"""Multi-LoRA adapter parameters for the Llama-family forward.

Port of dynamo_tpu/models/lora.py. Every registered adapter's low-rank
factors are stacked on a slot axis (slot 0 is the all-zero base slot), and
each token carries a slot index (a sequence's, or a flat ragged token's):
the forward adds x @ A[s] @ B[s] to the base projection (models/llama.py
`forward(lora=, adapter_idx=)`, through `slot_mask` and `delta`), so one
batch mixes adapters freely.

Layout per target projection t with base weight [L, in, out]:
  {t}_a: [L, n_slots, in, r]   {t}_b: [L, n_slots, r, out]
alpha / rank is folded into B when an adapter is registered. Targets are
wq, wk, wv, wo and, on a model without MoE layers, w_gate, w_up, w_down.

`random_adapter` draws the reference's factors bit for bit (numpy, the
same generator calls); `load_peft_adapter` reads a HuggingFace PEFT
checkpoint through engine/st_io.py (no `safetensors` package);
`lora_from_numpy` carries a stacked tree of the JAX package's layout onto
a device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch.engine.st_io import load_file
from dynamo_tpu_torch.models.config import ModelConfig

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")

# HF PEFT projection names -> the params tree's
HF_TO_OURS = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}


def _target_dims(c: ModelConfig) -> Dict[str, tuple]:
    """target name -> (in, out) of its base projection."""
    hd = c.head_dim
    dims = {
        "wq": (c.dim, c.n_heads * hd),
        "wk": (c.dim, c.n_kv_heads * hd),
        "wv": (c.dim, c.n_kv_heads * hd),
        "wo": (c.n_heads * hd, c.dim),
    }
    if not c.is_moe:
        dims.update({
            "w_gate": (c.dim, c.ffn_dim),
            "w_up": (c.dim, c.ffn_dim),
            "w_down": (c.ffn_dim, c.dim),
        })
    return dims


def lora_shapes(config: ModelConfig, n_slots: int, rank: int,
                targets: Sequence[str]) -> Dict[str, tuple]:
    """The stacked tree's leaf shapes ({t}_a, {t}_b per target)."""
    dims = _target_dims(config)
    unknown = [t for t in targets if t not in dims]
    if unknown:
        raise ValueError(f"LoRA targets {unknown} are not projections of "
                         f"{config.name} (one of {sorted(dims)})")
    L = config.n_layers
    out: Dict[str, tuple] = {}
    for t in targets:
        di, do = dims[t]
        out[t + "_a"] = (L, n_slots, di, rank)
        out[t + "_b"] = (L, n_slots, rank, do)
    return out


def lora_bytes(config: ModelConfig, n_slots: int, rank: int,
               targets: Sequence[str], dtype=torch.bfloat16) -> int:
    """Device bytes of the stacked tree init_lora_params places."""
    item = torch.empty((), dtype=dtype).element_size()
    total = 0
    for shape in lora_shapes(config, n_slots, rank, targets).values():
        n = 1
        for d in shape:
            n *= d
        total += n * item
    return total


def init_lora_params(config: ModelConfig, n_slots: int, rank: int = 8,
                     targets: Sequence[str] = DEFAULT_TARGETS,
                     dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """The zero stacked tree ({"layers": {...}}) on `device`; slot 0 is the
    base (stays all-zero), registration fills slots 1..n_slots-1."""
    return {"layers": {
        name: torch.zeros(shape, dtype=dtype, device=device)
        for name, shape in lora_shapes(config, n_slots, rank, targets).items()}}


def slot_mask(tok_slot: torch.Tensor, n_slots: int, dtype) -> torch.Tensor:
    """Each token's slot one-hot on the slot axis, in `dtype`: [...,
    n_slots, 1] for tok_slot [...]."""
    return (tok_slot[..., None] == torch.arange(
        n_slots, device=tok_slot.device)).to(dtype)[..., None]


def delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """x @ A[s] @ B[s] for each token's slot s: x [..., in], one layer's
    stacked factors a [n, in, r] and b [n, r, out], mask [..., n, 1]
    (`slot_mask`, broadcast over x's leading axes). Two products over
    every slot at once, x @ [A_0 .. A_n] masked to the token's slot, then
    @ [B_0; ..; B_n]: each slot's factors are read once, nothing is
    gathered, and a base-slot token (all-zero factors) gets an exact
    zero."""
    n, din, r = a.shape
    lead = x.shape[:-1]
    xa = (x @ a.transpose(0, 1).reshape(din, n * r)).view(*lead, n, r) * mask
    return xa.view(*lead, n * r) @ b.reshape(n * r, -1)


def random_adapter(config: ModelConfig, rank: int = 8,
                   targets: Sequence[str] = DEFAULT_TARGETS, seed: int = 0,
                   scale: float = 1.0) -> Dict[str, np.ndarray]:
    """A synthetic non-zero adapter: {"{t}_a": [L, in, r], "{t}_b":
    [L, r, out]} f32, both factors random so outputs change (the
    reference's draws, bit for bit)."""
    rng = np.random.default_rng(seed)
    dims = _target_dims(config)
    L = config.n_layers
    out: Dict[str, np.ndarray] = {}
    for t in targets:
        di, do = dims[t]
        out[t + "_a"] = (rng.standard_normal((L, di, rank)) * (di**-0.5)).astype(np.float32)
        out[t + "_b"] = (rng.standard_normal((L, rank, do)) * scale
                         * (rank**-0.5)).astype(np.float32)
    return out


def set_adapter_slot(lora: Dict[str, Any], slot: int,
                     adapter: Mapping[str, Any]) -> Dict[str, Any]:
    """Copy one adapter's factors ([L, in, r] / [L, r, out], numpy or
    torch, alpha / rank already folded into B) into `slot` of the stacked
    tree, in place. Raises on a factor the tree has no target for, or of
    another shape (before anything is written)."""
    layers = lora["layers"]
    unknown = [n for n in adapter if n not in layers]
    if unknown:
        raise ValueError(
            f"adapter factors {unknown} target projections the stacked tree "
            f"was not built for (targets {sorted({k[:-2] for k in layers})}); "
            "build the runner with lora_targets covering them")
    staged = {}
    for name, arr in adapter.items():
        t = torch.as_tensor(np.asarray(arr) if not torch.is_tensor(arr) else arr)
        want = layers[name][:, slot].shape
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"adapter factor {name} has shape {tuple(t.shape)}, "
                             f"the slot holds {tuple(want)}")
        staged[name] = t
    for name, t in staged.items():
        dst = layers[name]
        dst[:, slot].copy_(t.to(dst.device, dst.dtype))
    return lora


def load_peft_adapter(adapter_dir: str, config: ModelConfig) -> Dict[str, np.ndarray]:
    """A HuggingFace PEFT LoRA checkpoint (adapter_model*.safetensors and
    adapter_config.json) as the per-adapter factor dict, f32, with alpha /
    rank folded into B. HF stores lora_A [r, in] and lora_B [out, r];
    ours are transposed. Raises when a target's factors miss a layer."""
    d = Path(adapter_dir)
    cfg = json.loads((d / "adapter_config.json").read_text())
    rank = int(cfg["r"])
    scaling = float(cfg.get("lora_alpha", rank)) / rank
    files = sorted(d.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {adapter_dir}")
    tensors: Dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(load_file(f))

    L = config.n_layers
    out: Dict[str, List[Optional[np.ndarray]]] = {}
    for name, t in tensors.items():
        # ...model.layers.{i}.self_attn.q_proj.lora_A.weight
        parts = name.split(".")
        try:
            i = parts.index("layers")
            layer = int(parts[i + 1])
            proj = next(p for p in parts if p in HF_TO_OURS)
            which = "a" if "lora_A" in name else "b"
        except (ValueError, StopIteration, IndexError):
            continue
        key = f"{HF_TO_OURS[proj]}_{which}"
        out.setdefault(key, [None] * L)
        arr = t.float().numpy()  # bf16 and f16 widen exactly
        mat = np.ascontiguousarray(arr.T).astype(np.float32)  # [in, r] / [r, out]
        if which == "b":
            mat = mat * scaling
        out[key][layer] = mat

    stacked: Dict[str, np.ndarray] = {}
    for key, mats in out.items():
        if any(m is None for m in mats):
            raise ValueError(f"adapter {adapter_dir}: missing layers for {key}")
        stacked[key] = np.stack(mats)
    return stacked


def lora_from_numpy(tree: Mapping[str, Any], config: ModelConfig, device,
                    dtype=torch.bfloat16) -> Dict[str, Any]:
    """A stacked tree of the JAX package's layout ({"layers": {"{t}_a":
    [L, n_slots, in, r], "{t}_b": [L, n_slots, r, out]}}, numpy or
    array-like) -> the port's tree on `device` in `dtype`. Raises on a
    target the config has no projection for, or a shape that does not
    match it."""
    layers = tree["layers"]
    names = sorted(layers)
    a_names = [n for n in names if n.endswith("_a")]
    if not a_names:
        raise ValueError(f"LoRA tree without A factors: {names}")
    a_shape = np.shape(layers[a_names[0]])  # [L, n_slots, in, r]
    want = lora_shapes(config, a_shape[1], a_shape[-1], sorted({n[:-2] for n in names}))
    if set(want) != set(names):
        raise KeyError(f"LoRA tree leaves {names}, wanted {sorted(want)}")
    out = {}
    for n in names:
        arr = np.array(layers[n], dtype=np.float32)  # a writable copy
        if tuple(arr.shape) != want[n]:
            raise ValueError(f"{n}: shape {arr.shape}, {config.name} wants {want[n]}")
        out[n] = torch.from_numpy(arr).to(device=device, dtype=dtype)
    return {"layers": out}

