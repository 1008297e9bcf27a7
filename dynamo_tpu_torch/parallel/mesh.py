"""The parallel layout: the mesh's axes, a rank's place on them and the
split rule.

Port of dynamo_tpu/parallel/mesh.py `MeshConfig` and of `ShardingPolicy`'s
`param_spec`, `kv_pool_spec` and `kv_pool_sharding_tree`. The reference
places one array over a device mesh and lets XLA insert the collectives;
here each rank is a process (parallel/group.py) that holds its own slice
of every tensor, and a rank's slice is what the reference's NamedSharding
puts on device r of its mesh: rank r sits at `np.unravel_index(r, shape)`
of the (data, model, expert, seq, pipe) shape, as `make_mesh` reshapes
the devices row-major, and a tensor cut over an axis of n is cut into n
equal contiguous parts along the dim the rule names, the part of the
rank's coordinate on that axis kept.

The rule over `model` (`param_cut`, by leaf name): column-parallel
projections (wq, wk, wv, w_gate, w_up and the shared experts' ws_gate,
ws_up) cut their output dim, so a rank's query heads stay with their KV
head (head h = kv * G + g); MLA's wq_up and wkv_b cut it too (their
columns are head-major, so a contiguous part is a rank's heads, in step
with wo's row cut: a departure in memory only, the reference keeps both
whole and lets shard_map slice q's heads), while wq_lat, q_lat_norm,
wkv_a and kv_norm stay whole; row-parallel ones (wo, w_down, ws_down) cut
their input dim; Qwen2's bq, bk, bv follow the column cut; the embedding
[V, E] cuts E and an untied head [E, V] cuts V; the routed experts'
we_gate / we_up [L, n, E, F] cut F and we_down its F; norms (q_norm and
k_norm included), the router and scalars are whole on every rank. The
rule over `expert` (`expert_cut`): the routed experts' stacks cut their
expert dim (dim 1 of [L, n, ...]), so a rank holds n / expert whole
experts (each F / model wide); every other leaf is whole over `expert`,
and every leaf is whole over `data` (the reference's param_spec names no
data axis: a data index holds a whole replica of its model and expert
peers). The KV pools [L, NP, PS, Hk, D] and an int8 pool's scales
[L, NP, PS, Hk] cut Hk over `model` (dim KV_CUT of both) and are whole
over the other axes; an MLA latent pool (Hk 1) is whole on every rank
(`kv_cut`), as the reference replicates it.

This slice serves `data`, `model` and `expert` (`check_supported` refuses
`seq` and `pipe`). What it does not serve on a mesh of more than one rank
is decided here, in one table (TP_REFUSED) and one list of runner calls
(TP_REFUSED_CALLS), each entry naming the ROADMAP item that ports it:
`check_tp` refuses a config, a runner argument or a worker flag when a
parallel runner is built, and parallel/group.py MirroredRunner refuses
every runner call it neither mirrors nor reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

AXES = ("data", "model", "expert", "seq", "pipe")

# the ROADMAP items that port what this slice refuses
ITEM_SEQ_PIPE = "ROADMAP A.15 (sequence and pipeline parallelism)"
ITEM_QUANT = ("ROADMAP A.14 (c) (A.6's sharded quantized trees; quantized experts "
              "under EP, the reference's dense fallback)")
ITEM_LORA = "ROADMAP A.14 (c) (A.9's sharded stacked tree)"
ITEM_DRAFT = "ROADMAP A.14 (c) (a sharded draft)"
ITEM_TIERS = "ROADMAP A.14 (c) (the KV tiers' sharded pages)"
ITEM_WEIGHTS = "ROADMAP A.14 (c) (sharded weight reloads and warm tiers)"
ITEM_HOST_STEPS = ("ROADMAP A.14 (c) (host work between steps, "
                   "embeddings and device drafts)")

# what this slice refuses on a mesh of more than one rank: (what, the
# runner argument that asks for it or None, the worker flags that ask for
# it, the item that ports it)
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
# runner calls refused on a mesh of more than one rank, and the item that
# ports each; MirroredRunner refuses any other call it neither mirrors nor
# reads too, naming TP_ITEM
TP_ITEM = "ROADMAP A.14 (c)"
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
            "bq", "bk", "bv", "embed", "lm_head", "wq_up", "wkv_b")
_CUT_IN = ("wo", "w_down", "ws_down")
_CUT_EXPERT_F = {"we_gate": -1, "we_up": -1, "we_down": -2}
# the routed experts' stacks [L, n, E, F] / [L, n, F, E]: the expert dim
# cuts over the expert axis
ROUTED_EXPERTS = ("we_gate", "we_up", "we_down")
EXPERT_CUT = -3

# a KV pool's head dim, in the pool [L, NP, PS, Hk, D] and its scales
KV_CUT = 3

# the worker flag of each axis, for messages
_AXIS_FLAGS = {"data": "data", "model": "tensor", "expert": "expert",
               "seq": "sequence", "pipe": "pipeline"}


def kv_cut(config) -> Optional[int]:
    """The dim a rank's KV pools cut over `model`: KV_CUT, or None for an
    MLA latent pool (one latent a token, whole on every rank)."""
    return None if config.is_mla else KV_CUT


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
        """Raise for an axis this slice does not serve (seq, pipe) and for
        an axis below 1."""
        for axis, n in zip(AXES, self.shape):
            if n < 1:
                raise ValueError(f"{axis} axis of {n}: at least 1")
            if axis in ("seq", "pipe") and n > 1:
                raise NotImplementedError(
                    f"{axis} parallelism ({axis}={n}) is not ported yet: {ITEM_SEQ_PIPE}")

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank `rank`'s index on each axis: np.unravel_index over the
        shape, row-major as the reference's make_mesh lays out devices."""
        return dict(zip(AXES, (int(i) for i in np.unravel_index(rank, self.shape))))

    def peers(self, rank: int, axis: str) -> List[int]:
        """The ranks that share every coordinate of `rank` but `axis`'s, in
        the order of that axis: `rank`'s group over the axis."""
        c = self.coords(rank)
        out = []
        for i in range(getattr(self, axis)):
            c[axis] = i
            out.append(int(np.ravel_multi_index(tuple(c[a] for a in AXES), self.shape)))
        return out

    def describe(self) -> str:
        """The axes over 1 as the worker's flags name them, e.g. "tensor
        parallelism 2 x expert parallelism 2" ("one rank" for a 1-rank
        mesh)."""
        parts = [f"{_AXIS_FLAGS[a]} parallelism {n}" for a, n in zip(AXES, self.shape)
                 if n > 1]
        return " x ".join(parts) or "one rank"


def as_mesh(mesh: Union[int, MeshConfig]) -> MeshConfig:
    """A MeshConfig, or an int as a tensor-parallel mesh of that many ranks."""
    return mesh if isinstance(mesh, MeshConfig) else MeshConfig(model=int(mesh))


def param_cut(name: str) -> Optional[int]:
    """The dim leaf `name` ("wq", or a path such as "layers/wq") cuts over
    the model axis, negative from the end; None: whole on every rank."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf in _CUT_OUT:
        return -1
    if leaf in _CUT_IN:
        return -2
    return _CUT_EXPERT_F.get(leaf)


def expert_cut(name: str) -> Optional[int]:
    """The dim leaf `name` cuts over the expert axis (EXPERT_CUT for the
    routed experts' stacks), or None: whole over `expert`."""
    return EXPERT_CUT if name.rsplit("/", 1)[-1] in ROUTED_EXPERTS else None


def local_shape(shape: Tuple[int, ...], dim: Optional[int], tp: int) -> Tuple[int, ...]:
    """A rank's shape of a tensor of `shape` cut along `dim` into tp parts."""
    if dim is None or tp == 1:
        return tuple(shape)
    out = list(shape)
    if out[dim] % tp:
        raise ValueError(f"dim {dim} of {tuple(shape)} does not divide into {tp} parts")
    out[dim] //= tp
    return tuple(out)


def leaf_shape(name: str, shape: Tuple[int, ...], tp: int = 1, ep: int = 1) -> Tuple[int, ...]:
    """A rank's shape of leaf `name` of whole `shape`: cut over tp model
    ranks and ep expert ranks by the rule."""
    return local_shape(local_shape(shape, expert_cut(name), ep), param_cut(name), tp)


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


def narrow_leaf(name: str, t: torch.Tensor, rank: int = 0, tp: int = 1,
                ep_rank: int = 0, ep: int = 1) -> torch.Tensor:
    """A view of the part of leaf `name`'s whole tensor `t` that model
    rank `rank` of tp and expert rank `ep_rank` of ep hold."""
    for dim, i, n in ((expert_cut(name), ep_rank, ep), (param_cut(name), rank, tp)):
        if dim is None or n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not divide "
                             f"into {n} parts")
        w = t.shape[dim] // n
        t = t.narrow(dim, i * w, w)
    return t


def cut_leaf(name: str, t: torch.Tensor, rank: int = 0, tp: int = 1,
             ep_rank: int = 0, ep: int = 1) -> torch.Tensor:
    """narrow_leaf as a contiguous copy (`t` itself when nothing is cut)."""
    out = narrow_leaf(name, t, rank, tp, ep_rank, ep)
    return t if out is t else out.contiguous()


def local_param_shapes(shapes: Mapping[str, Any], tp: int, ep: int = 1) -> Dict[str, Any]:
    """models/llama.py `param_shapes` as one rank of tp model and ep
    expert ranks holds them."""
    out: Dict[str, Any] = {}
    for name, v in shapes.items():
        if isinstance(v, Mapping):
            out[name] = {n: leaf_shape(n, sh, tp, ep) for n, sh in v.items()}
        else:
            out[name] = leaf_shape(name, v, tp, ep)
    return out


def shard_tree(tree: Mapping[str, Any], full: Mapping[str, Any], rank: int,
               tp: int, ep_rank: int = 0, ep: int = 1) -> Dict[str, Any]:
    """The params of model rank `rank` (of tp) and expert rank `ep_rank`
    (of ep) of a tree of tensors: each leaf of the whole tree's shape
    (`full`, param_shapes) is cut by the rule, a leaf that already has the
    rank's shape is kept; any other shape raises."""
    local = local_param_shapes(full, tp, ep)

    def one(name, leaf, want_full, want_local):
        if tuple(leaf.shape) == tuple(want_local):
            return leaf
        if tuple(leaf.shape) == tuple(want_full):
            return cut_leaf(name, leaf, rank, tp, ep_rank, ep)
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


def refuse_tp(what: str, item: str = TP_ITEM,
              under: str = "tensor, expert or data parallelism"):
    """The error for `what` on a parallel mesh, naming its item."""
    return NotImplementedError(f"{what} under {under} is not ported yet: {item}")


def refused_call_item(name: str) -> str:
    """The item that ports runner call `name` on a parallel mesh."""
    return TP_REFUSED_CALLS.get(name, TP_ITEM)


def check_tp_flags(args, mesh: Union[int, MeshConfig]) -> None:
    """Raise for a worker flag of TP_REFUSED set on a mesh of more than
    one rank (an int: a tensor-parallel mesh of that many)."""
    mesh = as_mesh(mesh)
    if mesh.n_devices == 1:
        return
    for what, _, flags, item in TP_REFUSED:
        for flag in flags:
            if getattr(args, flag[2:].replace("-", "_"), None):
                raise refuse_tp(f"{flag} ({what})", item, mesh.describe())


def check_tp(config, mesh: Union[int, MeshConfig],
             runner_kw: Optional[Mapping[str, Any]] = None) -> None:
    """Raise unless `config`, built with the ModelRunner arguments
    `runner_kw`, can be served on `mesh` (an int: that many tensor-parallel
    ranks) in this slice: only the axes check_supported serves, no runner
    argument of TP_REFUSED set on more than one rank, every width the
    model cut divides by `model` (a GQA config's KV heads, an MLA config's
    heads, the dense FFN, the routed and shared experts' widths, the model
    width and an untied vocabulary) and the routed experts by `expert` (a
    dense config is whole over `expert`, as over `data`)."""
    mesh = as_mesh(mesh)
    mesh.check_supported()
    if mesh.n_devices == 1:
        return
    for what, arg, _, item in TP_REFUSED:
        if arg is not None and (runner_kw or {}).get(arg):
            raise refuse_tp(what, item, mesh.describe())
    tp = mesh.model
    dims = {"dim": config.dim}
    if config.is_mla:
        dims["n_heads"] = config.n_heads
    else:
        dims["n_kv_heads"] = config.n_kv_heads
    if not config.is_moe or config.n_dense_layers:
        dims["ffn_dim"] = config.ffn_dim
    if config.is_moe:
        dims["moe_ffn_dim"] = config.moe_ffn_dim
        if config.n_shared_experts:
            dims["shared_ffn_dim"] = config.shared_ffn_dim
    if not config.tie_embeddings:
        dims["vocab_size"] = config.vocab_size
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise ValueError(f"{config.name} does not divide over {tp} ranks: {bad}")
    if config.is_moe and config.n_experts % mesh.expert:
        raise ValueError(f"{config.name} does not divide over {mesh.expert} expert "
                         f"ranks: n_experts {config.n_experts}")
