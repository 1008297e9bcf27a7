"""The tensor-parallel layout: the mesh's axes and the split rule.

Port of dynamo_tpu/parallel/mesh.py `MeshConfig` and of `ShardingPolicy`'s
`param_spec`, `kv_pool_spec` and `kv_pool_sharding_tree`. The reference
places one array over a device mesh and lets XLA insert the collectives;
here each rank is a process (parallel/group.py) that holds its own slice
of every tensor, and a rank's slice is what the reference's NamedSharding
puts on device r of the `model` axis: the tensor cut into `tp` equal
contiguous parts along the one dimension the rule names, part r kept.

The rule (`param_cut`, by leaf name): column-parallel projections (wq, wk,
wv, w_gate, w_up and the shared experts' ws_gate, ws_up) cut their output
dim, so a rank's query heads stay with their KV head (head h = kv * G + g);
row-parallel ones (wo, w_down, ws_down) cut their input dim; Qwen2's bq,
bk, bv follow the column cut; the embedding [V, E] cuts E and an untied
head [E, V] cuts V; the routed experts' we_gate / we_up [L, n, E, F] cut
F and we_down its F; norms (q_norm and k_norm included), the router and
scalars are whole on every rank. The KV pools [L, NP, PS, Hk, D] and an
int8 pool's scales [L, NP, PS, Hk] cut Hk (dim KV_CUT of both).

This slice serves `model` > 1 alone, for the dense GQA families. What it
does not serve under tensor parallelism is decided here, in one table
(TP_REFUSED) and one list of runner calls (TP_REFUSED_CALLS), each entry
naming the ROADMAP item that ports it: `check_supported` refuses the other
axes, `check_tp` a config, a runner argument or a worker flag when a
tensor-parallel runner is built, and parallel/group.py MirroredRunner
refuses every runner call it neither mirrors nor reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

AXES = ("data", "model", "expert", "seq", "pipe")

# the ROADMAP items that port what this slice refuses
ITEM_MLA_EP_DP = "ROADMAP A.14 (second half: MLA, expert and data parallelism)"
ITEM_SEQ_PIPE = "ROADMAP A.15 (sequence and pipeline parallelism)"
ITEM_QUANT = "ROADMAP A.14 (second half: A.6's sharded quantized trees)"
ITEM_LORA = "ROADMAP A.14 (second half: A.9's sharded stacked tree)"
ITEM_DRAFT = "ROADMAP A.14 (second half: a sharded draft)"
ITEM_TIERS = "ROADMAP A.14 (second half: the KV tiers' sharded pages)"
ITEM_WEIGHTS = "ROADMAP A.14 (second half: sharded weight reloads and warm tiers)"
ITEM_HOST_STEPS = ("ROADMAP A.14 (second half: host work between steps, "
                   "embeddings and device drafts)")

# what this slice refuses under tensor parallelism: (what, the runner
# argument that asks for it or None, the worker flags that ask for it,
# the item that ports it)
TP_REFUSED = (
    ("quantized weights", "quantize", ("--quantize",), ITEM_QUANT),
    ("LoRA adapters", "lora_slots", ("--lora", "--lora-slots"), ITEM_LORA),
    ("a draft model", "draft_config", ("--draft-model", "--spec-draft-model"),
     ITEM_DRAFT),
    ("a draft checkpoint", "draft_params", ("--draft-checkpoint",), ITEM_DRAFT),
    ("the KV tiers", None, ("--host-kv-blocks", "--disk-kv-blocks", "--disk-kv-root",
                            "--obj-kv-root", "--kv-tier-quantize", "--prefetch"),
     ITEM_TIERS),
    ("the warm weight tiers", None, ("--shm-weights", "--orbax-cache"), ITEM_WEIGHTS),
)
# runner calls refused under tensor parallelism, and the item that ports
# each; MirroredRunner refuses any other call it neither mirrors nor reads
# too, naming TP_ITEM
TP_ITEM = "ROADMAP A.14 (second half)"
TP_REFUSED_CALLS = {
    "reload_params": ITEM_WEIGHTS,
    "export_page_blocks": ITEM_TIERS,
    "reserve_host_memory": ITEM_TIERS,
    "register_adapter": ITEM_LORA,
    "draft_prefill": ITEM_DRAFT,
    "spec_decode_multi": ITEM_DRAFT,
    "embed": ITEM_HOST_STEPS,
    "ensure_draft_ring": ITEM_HOST_STEPS,
    "draft_ring_reset": ITEM_HOST_STEPS,
    "draft_step": ITEM_HOST_STEPS,
}

# the dim each leaf cuts over the model axis (negative: from the end), by
# leaf name; a name not listed is whole on every rank
_CUT_OUT = ("wq", "wk", "wv", "w_gate", "w_up", "ws_gate", "ws_up",
            "bq", "bk", "bv", "embed", "lm_head")
_CUT_IN = ("wo", "w_down", "ws_down")
_CUT_EXPERT_F = {"we_gate": -1, "we_up": -1, "we_down": -2}

# a KV pool's head dim, in the pool [L, NP, PS, Hk, D] and its scales
KV_CUT = 3


@dataclass(frozen=True)
class MeshConfig:
    """The mesh's axis sizes, the reference's fields and order."""

    data: int = 1
    model: int = 1
    expert: int = 1
    seq: int = 1
    pipe: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.expert * self.seq * self.pipe

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.data, self.model, self.expert, self.seq, self.pipe)

    def check_supported(self) -> None:
        """Raise for an axis this slice does not serve: only `model` may
        exceed 1."""
        for axis, n in zip(AXES, self.shape):
            if axis == "model" or n == 1:
                continue
            item = ITEM_SEQ_PIPE if axis in ("seq", "pipe") else ITEM_MLA_EP_DP
            raise NotImplementedError(
                f"{axis} parallelism ({axis}={n}) is not ported yet: {item}")


def param_cut(name: str) -> Optional[int]:
    """The dim leaf `name` ("wq", or a path such as "layers/wq") cuts over
    the model axis, negative from the end; None: whole on every rank."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf in _CUT_OUT:
        return -1
    if leaf in _CUT_IN:
        return -2
    return _CUT_EXPERT_F.get(leaf)


def local_shape(shape: Tuple[int, ...], dim: Optional[int], tp: int) -> Tuple[int, ...]:
    """A rank's shape of a tensor of `shape` cut along `dim` into tp parts."""
    if dim is None or tp == 1:
        return tuple(shape)
    out = list(shape)
    if out[dim] % tp:
        raise ValueError(f"dim {dim} of {tuple(shape)} does not divide into {tp} parts")
    out[dim] //= tp
    return tuple(out)


def cut(t: torch.Tensor, dim: Optional[int], rank: int, tp: int) -> torch.Tensor:
    """Part `rank` of `t` cut along `dim` into tp equal contiguous parts
    (a contiguous copy; `t` itself when nothing is cut)."""
    if dim is None or tp == 1:
        return t
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide into {tp} parts")
    w = n // tp
    return t.narrow(dim, rank * w, w).contiguous()


def local_param_shapes(shapes: Mapping[str, Any], tp: int) -> Dict[str, Any]:
    """models/llama.py `param_shapes` as one rank holds them."""
    out: Dict[str, Any] = {}
    for name, v in shapes.items():
        if isinstance(v, Mapping):
            out[name] = {n: local_shape(sh, param_cut(n), tp) for n, sh in v.items()}
        else:
            out[name] = local_shape(v, param_cut(name), tp)
    return out


def shard_tree(tree: Mapping[str, Any], full: Mapping[str, Any], rank: int,
               tp: int) -> Dict[str, Any]:
    """Rank `rank`'s params of a tree of tensors: each leaf of the whole
    tree's shape (`full`, param_shapes) is cut by the rule, a leaf that
    already has the rank's shape is kept; any other shape raises."""
    local = local_param_shapes(full, tp)

    def one(name, leaf, want_full, want_local):
        if tuple(leaf.shape) == tuple(want_local):
            return leaf
        if tuple(leaf.shape) == tuple(want_full):
            return cut(leaf, param_cut(name), rank, tp)
        raise ValueError(f"{name}: shape {tuple(leaf.shape)} is neither the whole "
                         f"{tuple(want_full)} nor rank {rank}'s {tuple(want_local)}")

    out: Dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = {n: one(n, x, full[name][n], local[name][n])
                         for n, x in leaf.items()}
        else:
            out[name] = one(name, leaf, full[name], local[name])
    return out


def refuse_tp(what: str, item: str = TP_ITEM):
    """The error for `what` under tensor parallelism, naming its item."""
    return NotImplementedError(
        f"{what} under tensor parallelism is not ported yet: {item}")


def refused_call_item(name: str) -> str:
    """The item that ports runner call `name` under tensor parallelism."""
    return TP_REFUSED_CALLS.get(name, TP_ITEM)


def check_tp_flags(args, tp: int) -> None:
    """Raise for a worker flag of TP_REFUSED set under tp > 1 ranks."""
    if tp == 1:
        return
    for what, _, flags, item in TP_REFUSED:
        for flag in flags:
            if getattr(args, flag[2:].replace("-", "_"), None):
                raise refuse_tp(f"{flag} ({what}) under --tensor-parallel {tp}", item)


def check_tp(config, tp: int, runner_kw: Optional[Mapping[str, Any]] = None) -> None:
    """Raise unless `config`, built with the ModelRunner arguments
    `runner_kw`, can be served over tp ranks in this slice: a dense GQA
    family whose KV heads, FFN width, model width and (untied) vocabulary
    each divide by tp, with no runner argument of TP_REFUSED set."""
    if tp == 1:
        return
    if config.is_mla:
        raise refuse_tp(f"{config.name}: MLA models", ITEM_MLA_EP_DP)
    if config.is_moe:
        raise refuse_tp(f"{config.name}: MoE models", ITEM_MLA_EP_DP)
    for what, arg, _, item in TP_REFUSED:
        if arg is not None and (runner_kw or {}).get(arg):
            raise refuse_tp(what, item)
    dims = {"n_kv_heads": config.n_kv_heads, "ffn_dim": config.ffn_dim,
            "dim": config.dim}
    if not config.tie_embeddings:
        dims["vocab_size"] = config.vocab_size
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise ValueError(f"{config.name} does not divide over {tp} ranks: {bad}")
