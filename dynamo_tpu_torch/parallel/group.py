"""Ranks as processes: the world and its groups over the mesh's axes, their
collectives, the mirrored runner on rank 0 and the followers' loop.

The reference serves a `MeshConfig(data=D, model=M, expert=X)` from one
process and leaves the collectives to XLA. Here each of its D M X ranks
is a process of a `torch.distributed` world: rank 0 holds the engine, the
scheduler and the request plane, and ranks 1..N-1 are followers
(`spawn_followers`, torch.multiprocessing's spawn) that hold their own
slice of the params and KV pools (parallel/mesh.py) and run the same
runner calls in the same order. A rank sits at the mesh coordinates of
`MeshConfig.coords` and holds a gloo group over each axis above 1
(`TPGroup.axes`, AxisGroup: the ranks that share its other coordinates):
the forward runs attention's and the FFN's all-reduces and gathers over
the `model` group and the MoE token dispatch (`all_to_all`) or its
fallback's all-reduce over the `expert` group; the `data` group carries
nothing in the forward (a data rank computes what its peers compute, as
the reference's runner places no batch over `data`). Rank
0's runner is wrapped in `MirroredRunner`: every call that touches the
params or the pools is first broadcast, as its name and its host arguments
(numpy or plain Python, pickled), over a CPU (gloo) group, then run
locally; each follower runs the same method on its own ModelRunner. The
collectives inside the forward pass (`all_reduce`, `all_gather`,
`all_to_all`) keep the ranks in step. Every rank samples the same
tokens from the same gathered logits with the same seeded generators, so
a decode loop needs no token broadcast; each rank folds the arrays its calls return into a digest, and
`MirroredRunner.rank_reports` gathers them (with each rank's launch
counts, runner counters and peak memory), so a follower whose tokens
differ from rank 0's shows.

After every mirrored call (and the build, and each attribute set) the
ranks trade its outcome (`TPGroup.call_status`: one allgather of a flag a
rank while every rank returns). The same error on every rank follows from
the call's arguments: rank 0 raises it to its caller and serving goes on.
Any other mix (one rank raised, or the ranks raised different errors: an
out-of-memory, a device fault or a collective's timeout on one rank) has
left the ranks' state apart: rank 0 raises naming every rank's error and
refuses every later call, and each follower exits non-zero, which the
worker's `FollowerWatch` turns into the worker's end with an error.

Transport, chosen from the ranks' device layout when the group is made
(`choose_transport`), never by catching an error: NCCL when every rank has
a card of its own; gloo when ranks share a card (NCCL refuses two ranks on
one device) or run on the CPU. Under gloo a CUDA tensor's collective goes
through a pinned host buffer in float32, explicitly (gloo takes neither
CUDA tensors for every op nor bfloat16 everywhere; a bf16 value is exact
in f32, and every rank rounds the same f32 sum back to bf16), a pinned
buffer grown as needed and reused. The calls' broadcasts ride a second gloo group
whose timeout is long (a follower may wait for the next call as long as
the worker idles); the collectives' own groups time out after
`timeout_s`, so a rank that stops answering ends a step with an error. `FollowerWatch` polls the followers' processes and
reports a death at once.
"""

from __future__ import annotations

import datetime
import gc
import hashlib
import logging
import math
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dynamo_tpu_torch.parallel.mesh import (
    ITEM_HOST_STEPS,
    MeshConfig,
    as_mesh,
    check_tp,
    leaf_shape,
    narrow_leaf,
    refuse_tp,
    refused_call_item,
)

log = logging.getLogger("dynamo_tpu_torch.parallel")

# a collective that waits longer than this on a rank raises
DEFAULT_TIMEOUT_S = 120.0
# how long a follower may wait for rank 0's next call
CALL_WAIT = datetime.timedelta(days=7)
# how long the ranks wait for each other to start (a spawn, its imports)
JOIN_WAIT = datetime.timedelta(seconds=120)

# the runner calls every rank runs, in rank 0's order: each touches the
# params or the pools, or changes the shapes the next forward takes
MIRRORED = (
    "prefill", "decode", "decode_multi", "decode_multi_ex",
    "decode_multi_with_prefill", "decode_multi_with_prefills", "verify_spec",
    "copy_pages", "export_pages", "export_pages_device", "import_pages",
    "import_page_tensors", "reset_kv_pools", "ensure_ragged_bucket",
    "reset_stats",
)
# what rank 0 reads of its own runner alone: values, and calls that
# neither touch the params or the pools nor change what the next forward
# takes (a token sampled from logits every rank holds is passed to the next
# mirrored call as an argument). Every other runner attribute is refused
# (parallel/mesh.py TP_REFUSED_CALLS names the item).
READ_ONLY = (
    "config", "device", "dtype", "stats", "num_pages", "page_size",
    "max_pages_per_seq", "kv_quantize", "quantize", "moe_layers", "attn_impl",
    "mesh_config", "tp_rank", "tp_size", "ep_rank", "ep_size", "ragged_mixed",
    "ragged_buckets", "decode_buckets", "prefill_buckets", "pack_buckets", "ragged_q_block",
    "has_draft", "draft_config", "spec_gamma", "guided_fused", "lora", "lora_rank",
    "lora_targets", "adapter_names", "adapter_slot", "kv_page_shape",
    "kv_wire_dtype", "compile_stats", "layout_table", "_families", "_use_ragged",
    "sample_one", "sample_one_ex", "attach_sanitizer",
)


def rank_device(rank: int, device) -> torch.device:
    """Rank r's device: the CPU for CPU ranks, else cuda:(r % cards)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def choose_transport(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a CUDA device of its own; gloo when ranks
    share a card or run on the CPU."""
    if any(d.type != "cuda" for d in devices):
        return "gloo"
    if len({d.index for d in devices}) < len(devices):
        return "gloo"
    return "nccl"


# what an AxisGroup counts of its collectives (reset_counters zeroes them)
COLLECTIVES = ("all_reduce", "all_gather", "all_to_all")


class AxisGroup:
    """A rank's group over one mesh axis: its index and size there, its device, and the collectives the forward pass runs
    over it (gloo through the host, or NCCL where every rank has a card).
    `stats` counts each collective's calls, the bytes this rank sent
    (all_to_all) or contributed, and their wall seconds on the host."""

    def __init__(self, axis: str, ranks: Sequence[int], rank: int, device,
                 gloo, nccl=None):
        self.axis = axis
        self.ranks = list(ranks)  # the world ranks, in the axis's order
        self.rank, self.size = self.ranks.index(rank), len(self.ranks)
        self.device = device
        self._gloo, self._nccl = gloo, nccl
        self._pinned: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {f"{op}_{k}": 0 for op in COLLECTIVES
                      for k in ("calls", "bytes", "seconds")}

    def _note(self, op: str, x: torch.Tensor, t0: float) -> None:
        self.stats[f"{op}_calls"] += 1
        self.stats[f"{op}_bytes"] += x.numel() * x.element_size()
        self.stats[f"{op}_seconds"] += time.perf_counter() - t0

    def _pinned_buffer(self, which: str, shape, dtype) -> torch.Tensor:
        """A pinned host buffer of `shape`: a view of one grown as needed and
        reused (collectives run one at a time, each copied out before it
        returns)."""
        n = math.prod(shape)
        buf = self._pinned.get((which, dtype))
        if buf is None or buf.numel() < n:
            buf = self._pinned[(which, dtype)] = torch.empty(
                max(n, 1 << 16), dtype=dtype, pin_memory=True)
        return buf[:n].view(shape)

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """x as gloo takes it: a CPU tensor, floats in f32 (CUDA tensors
        through the reused pinned buffer; a CPU f32 tensor is itself)."""
        dtype = torch.float32 if x.is_floating_point() else x.dtype
        if x.device.type == "cpu":
            return x.contiguous() if x.dtype == dtype else x.to(dtype)
        buf = self._pinned_buffer("send", tuple(x.shape), dtype)
        buf.copy_(x)  # waits for the device
        return buf

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the group, in place; returns x."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        if self._nccl is not None:
            self._nccl.allreduce([x]).wait()
        else:
            h = self._host(x)
            self._gloo.allreduce([h]).wait()
            if h is not x:
                x.copy_(h)
        self._note("all_reduce", x, t0)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `x` concatenated along `dim`, in the group's order."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        if self._nccl is not None:
            parts = [torch.empty_like(x) for _ in range(self.size)]
            self._nccl.allgather([parts], [x.contiguous()]).wait()
            out = torch.cat(parts, dim)
        else:
            h = self._host(x)
            parts = [torch.empty_like(h, device="cpu") for _ in range(self.size)]
            self._gloo.allgather([parts], [h]).wait()
            out = torch.cat(parts, dim).to(device=x.device, dtype=x.dtype)
        self._note("all_gather", x, t0)
        return out

    def all_to_all(self, x: torch.Tensor, send: Sequence[int],
                   recv: Sequence[int]) -> torch.Tensor:
        """Rows of x [sum(send), ...]: send[j] consecutive rows to rank j
        of the group, in order; returns the rows received [sum(recv), ...],
        recv[j] from rank j, in the group's order (the sizes must agree
        with what the peers send: exchange them first). A CPU tensor goes
        over gloo under either transport."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        send, recv = [int(n) for n in send], [int(n) for n in recv]
        shape = (sum(recv),) + tuple(x.shape[1:])
        if self._nccl is not None and x.device.type == "cuda":
            out = torch.empty(shape, dtype=x.dtype, device=x.device)
            self._nccl.alltoall_base(out, x.contiguous(), recv, send,
                                     dist.AllToAllOptions()).wait()
        else:
            h = self._host(x)
            out = (torch.empty(shape, dtype=h.dtype) if x.device.type == "cpu"
                   else self._pinned_buffer("recv", shape, h.dtype))
            self._gloo.alltoall_base(out, h, recv, send, dist.AllToAllOptions()).wait()
            out = out.to(device=x.device, dtype=x.dtype)
        self._note("all_to_all", x, t0)
        return out


class TPGroup:
    """One rank's view of the world: its rank, size, device and place on
    the mesh, the transport, its group over each mesh axis (`axes`:
    "model", "expert", "data"; None where the axis is 1: the forward's
    collectives), and the broadcasts the mirror uses."""

    def __init__(self, rank: int, size: int, store_path: str, device,
                 timeout_s: float = DEFAULT_TIMEOUT_S, mesh: Optional[MeshConfig] = None):
        mesh = mesh or MeshConfig(model=size)
        if mesh.n_devices != size:
            raise ValueError(f"a mesh of {mesh.n_devices} ranks over a world of {size}")
        self.rank, self.size = rank, size
        self.device = rank_device(rank, device)
        self.devices = [rank_device(r, device) for r in range(size)]
        self.transport = choose_transport(self.devices)
        self.timeout_s = timeout_s
        self.store_path = store_path
        # process groups of their own (no default group): a process may
        # hold several groups, one after another or at once
        store = dist.FileStore(store_path, size)
        # every rank has started before a group is made, so a follower's
        # start is not held to the collectives' timeout
        store.set(f"joined/{rank}", "1")
        store.wait([f"joined/{r}" for r in range(size)], JOIN_WAIT)
        self._world = dist.ProcessGroupGloo(
            dist.PrefixStore("world", store), rank, size,
            datetime.timedelta(seconds=timeout_s))
        self._calls = dist.ProcessGroupGloo(dist.PrefixStore("calls", store), rank,
                                            size, CALL_WAIT)
        self._nccl = (dist.ProcessGroupNCCL(dist.PrefixStore("nccl", store), rank, size)
                      if self.transport == "nccl" else None)
        self._store = store
        self._mesh_gen = 0
        self.set_axes(mesh)
        # this rank's ModelRunner while one is built (run_on_ranks reads it)
        self.runner = None
        self.closed = False

    def set_axes(self, mesh: MeshConfig) -> None:
        """Lay the world out as `mesh`: this rank's coordinates and a group
        over each axis above 1, made on every rank in the same order (data,
        model, expert), each from a store prefix of its own. An axis that
        spans the whole world reuses the world's groups."""
        if mesh.n_devices != self.size:
            raise ValueError(f"a mesh of {mesh.n_devices} ranks over a world of {self.size}")
        mesh.check_supported()
        self._mesh_gen += 1
        self.mesh = mesh
        self.coords = mesh.coords(self.rank)
        self.axes: Dict[str, Optional[AxisGroup]] = {}
        for axis in ("data", "model", "expert"):
            n = getattr(mesh, axis)
            if n == 1:
                self.axes[axis] = None
                continue
            peers = mesh.peers(self.rank, axis)
            if n == self.size:
                gloo, nccl = self._world, self._nccl
            else:
                prefix = f"axes{self._mesh_gen}/{axis}/{peers[0]}"
                gloo = dist.ProcessGroupGloo(
                    dist.PrefixStore(prefix, self._store), peers.index(self.rank), n,
                    datetime.timedelta(seconds=self.timeout_s))
                nccl = (dist.ProcessGroupNCCL(dist.PrefixStore(prefix + "/nccl", self._store),
                                              peers.index(self.rank), n)
                        if self.transport == "nccl" else None)
            self.axes[axis] = AxisGroup(axis, peers, self.rank, self.device, gloo, nccl)

    @property
    def model(self) -> Optional[AxisGroup]:
        return self.axes["model"]

    @property
    def expert(self) -> Optional[AxisGroup]:
        return self.axes["expert"]

    # -- the dispatch broadcast ----------------------------------------------
    def _broadcast(self, t: torch.Tensor) -> None:
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        self._calls.broadcast([t], opts).wait()

    def send_call(self, name: str, args: tuple = (), kwargs: Optional[dict] = None) -> None:
        """Rank 0: broadcast a call (pickled) to the followers."""
        data = pickle.dumps((name, args, kwargs or {}), protocol=pickle.HIGHEST_PROTOCOL)
        self._broadcast(torch.tensor([len(data)], dtype=torch.int64))
        self._broadcast(torch.frombuffer(bytearray(data), dtype=torch.uint8))

    def recv_call(self) -> Tuple[str, tuple, dict]:
        """A follower: wait for rank 0's next call."""
        n = torch.zeros(1, dtype=torch.int64)
        self._broadcast(n)
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        self._broadcast(buf)
        return pickle.loads(buf.numpy().tobytes())

    def call_status(self, err: Optional[BaseException]) -> List[Optional[str]]:
        """After a mirrored call, every rank's outcome, on every rank: None
        where the call returned, else the error's type and text. One
        allgather of a flag a rank when every rank returned."""
        flags = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        mine = torch.tensor([0 if err is None else 1], dtype=torch.int64)
        self._calls.allgather([flags], [mine]).wait()
        if not any(int(f[0]) for f in flags):
            return [None] * self.size
        return self.gather_objects(None if err is None else f"{type(err).__name__}: {err}")

    def send_tensor(self, t: torch.Tensor, dst: int) -> None:
        """Rank 0: a CPU tensor's bytes to rank `dst` alone."""
        if t.numel():
            self._calls.send([t.contiguous().reshape(-1).view(torch.uint8)], dst, 0).wait()

    def recv_tensor(self, shape, dtype) -> torch.Tensor:
        """A follower: rank 0's next send_tensor, as a CPU tensor."""
        t = torch.empty(shape, dtype=dtype)
        if t.numel():
            self._calls.recv([t.reshape(-1).view(torch.uint8)], 0, 0).wait()
        return t

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's `obj` (pickled), in rank order, on every rank."""
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        self._calls.allgather([sizes], [torch.tensor([len(data)], dtype=torch.int64)]).wait()
        n = max(int(s[0]) for s in sizes)
        mine = torch.zeros(n, dtype=torch.uint8)
        mine[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        parts = [torch.empty(n, dtype=torch.uint8) for _ in range(self.size)]
        self._calls.allgather([parts], [mine]).wait()
        return [pickle.loads(p[:int(s[0])].numpy().tobytes()) for p, s in zip(parts, sizes)]

    def remesh(self, mesh: MeshConfig) -> None:
        """Rank 0: lay every rank's world out as `mesh` (set_axes on each;
        no runner may be live across it). Raises if any rank failed."""
        self.send_call("__mesh__", (mesh,))
        err = None
        try:
            self.set_axes(mesh)
        except Exception as e:
            err = e
        outcomes = self.call_status(err)
        if any(outcomes):
            raise RuntimeError(f"remesh to {mesh}: {outcomes}") from err

    def run_on_ranks(self, fn: Callable[..., Any], *args) -> List[Any]:
        """Rank 0: fn(rank's group, *args) on every rank (fn importable by
        module and name, its arguments pickled; `group.runner` is the
        rank's runner, if one is built); every rank's result, in rank
        order. Raises naming the ranks that raised."""
        self.send_call("__run__", (fn.__module__, fn.__qualname__, args))
        outs = self.gather_objects(_run_one(self, fn, args))
        bad = [(r, o[1]) for r, o in enumerate(outs) if not o[0]]
        if bad:
            raise RuntimeError(f"run_on_ranks {fn.__qualname__}: {bad}")
        return [o[1] for o in outs]

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._world = self._calls = self._nccl = self._store = None
        self.axes = {}
        gc.collect()
        if self.rank == 0:
            shutil.rmtree(os.path.dirname(self.store_path), ignore_errors=True)


def _run_one(group: TPGroup, fn: Callable[..., Any], args: tuple) -> Tuple[bool, Any]:
    try:
        return True, fn(group, *args)
    except Exception as e:
        return False, f"{type(e).__name__}: {e}"


# -- per-rank counters -----------------------------------------------------------
def kernel_counters() -> Dict[str, Any]:
    """The wrappers a parallel pass can launch, by name: the GQA
    and MLA attention kernels, the page copies, their sharded
    counterparts, and the grouped GEMM's two entries."""
    from dynamo_tpu_torch.ops import block_copy, flash_prefill, mla_attention, paged_attention
    from dynamo_tpu_torch.ops import moe_dispatch
    from dynamo_tpu_torch.ops import ragged_paged_attention as rag

    return {
        "decode_paged_attention": paged_attention.decode_paged_attention,
        "prefill_paged_attention": flash_prefill.prefill_paged_attention,
        "ragged_paged_attention": rag.ragged_paged_attention,
        "gather_pages": block_copy.gather_pages,
        "scatter_pages": block_copy.scatter_pages,
        "scatter_pages_layers": block_copy.scatter_pages_layers,
        "decode_paged_attention_sharded": paged_attention.decode_paged_attention_sharded,
        "prefill_paged_attention_sharded": flash_prefill.prefill_paged_attention_sharded,
        "ragged_paged_attention_sharded": rag.ragged_paged_attention_sharded,
        "gather_pages_sharded": block_copy.gather_pages_sharded,
        "scatter_pages_sharded": block_copy.scatter_pages_sharded,
        "decode_mla_attention": mla_attention.decode_mla_attention,
        "prefill_mla_attention": mla_attention.prefill_mla_attention,
        "decode_mla_attention_sharded": mla_attention.decode_mla_attention_sharded,
        "prefill_mla_attention_sharded": mla_attention.prefill_mla_attention_sharded,
        "moe_gate_up": moe_dispatch.moe_gate_up,
        "moe_down": moe_dispatch.moe_down,
    }


def reset_counters(runner=None) -> None:
    """Zero this rank's launch counts (and bodies), its runner's counters
    and its device's peak memory."""
    for fn in kernel_counters().values():
        fn.launches = 0
        for attr in ("bodies", "heads"):
            if hasattr(fn, attr):
                setattr(fn, attr, {})
    from dynamo_tpu_torch.ops.moe_dispatch import EP_COUNTS

    for k in EP_COUNTS:
        EP_COUNTS[k] = 0
    if runner is not None:
        runner.reset_stats()
        for g in _axis_groups(runner):
            g.reset_stats()
        if runner.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(runner.device)


def _axis_groups(runner) -> List[AxisGroup]:
    group = getattr(runner, "group", None)
    if group is None:
        return []
    return [g for g in group.axes.values() if g is not None]


class Digest:
    """A running hash of the arrays a rank's calls return."""

    def __init__(self):
        self.h = hashlib.sha256()
        self.n = 0

    def fold(self, out: Any) -> None:
        if isinstance(out, np.ndarray):
            self.h.update(str((out.dtype, out.shape)).encode())
            self.h.update(np.ascontiguousarray(out).tobytes())
            self.n += 1
        elif isinstance(out, (tuple, list)):
            for x in out:
                self.fold(x)

    def value(self) -> Tuple[str, int]:
        return self.h.hexdigest(), self.n


def rank_report(rank: int, runner, digest: Digest) -> Dict[str, Any]:
    """What rank_reports gathers from one rank."""
    counters = kernel_counters()
    rep: Dict[str, Any] = {
        "rank": rank, "pid": os.getpid(),
        "launches": {k: fn.launches for k, fn in counters.items()},
        "bodies": {k: dict(fn.bodies) for k, fn in counters.items()
                   if hasattr(fn, "bodies")},
        "heads": {k: dict(fn.heads) for k, fn in counters.items()
                  if hasattr(fn, "heads")},
    }
    rep["digest"], rep["outputs"] = digest.value()
    from dynamo_tpu_torch.ops.moe_dispatch import EP_COUNTS

    rep["ep"] = dict(EP_COUNTS)
    if runner is not None:
        rep["device"] = str(runner.device)
        rep["coords"] = dict(runner.group.coords) if runner.group is not None else {}
        rep["collectives"] = {g.axis: dict(g.stats) for g in _axis_groups(runner)}
        rep["stats"] = dict(runner.stats)
        if runner.device.type == "cuda":
            rep["peak_bytes"] = torch.cuda.max_memory_allocated(runner.device)
    return rep


def diverged(outcomes: Sequence[Optional[str]]) -> bool:
    """Whether the ranks' outcomes of one call (call_status) leave their
    state apart: anything but every rank returning or every rank raising
    the same error."""
    return len(set(outcomes)) > 1


# -- a given params tree -----------------------------------------------------------
def _leaves(tree: Dict[str, Any]):
    """(path, leaf name, tensor) of a params tree, in its order."""
    for name, v in tree.items():
        if isinstance(v, dict):
            for n, x in v.items():
                yield (name, n), n, x
        else:
            yield (name,), name, v


def slice_manifest(params: Dict[str, Any], config, mesh) -> List[tuple]:
    """(path, a rank's shape, dtype) of every leaf of a whole params tree,
    in its order: what send_param_slices sends each follower (`mesh` a
    MeshConfig, or an int: that many tensor-parallel ranks)."""
    mesh = as_mesh(mesh)
    from dynamo_tpu_torch.models.llama import param_shapes

    full = param_shapes(config)
    out = []
    for path, leaf, t in _leaves(params):
        want = full[path[0]] if len(path) == 1 else full[path[0]][path[1]]
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} is not the whole "
                             f"{tuple(want)} (a tensor-parallel build takes a whole tree)")
        out.append((path, leaf_shape(leaf, want, mesh.model, mesh.expert), t.dtype))
    return out


def send_param_slices(group: TPGroup, params: Dict[str, Any],
                      manifest: List[tuple]) -> None:
    """Rank 0: each follower's slice of every leaf of a whole tree (cut by
    its coordinates on the mesh), to that follower alone, a leaf at a time
    through the host (one slice is transient). Every leaf is sent even
    after a copy fails (zeros in its place: the follower receives them
    all), then the first failure raises."""
    err = None
    mesh = group.mesh
    for r in range(1, group.size):
        c = mesh.coords(r)
        for (_, leaf, t), (_, shape, dtype) in zip(_leaves(params), manifest):
            try:
                part = narrow_leaf(leaf, t, c["model"], mesh.model, c["expert"],
                                   mesh.expert).to("cpu")
            except Exception as e:
                err = err or e
                part = torch.zeros(shape, dtype=dtype)
            group.send_tensor(part, r)
    if err is not None:
        raise err


def recv_param_slices(group: TPGroup, manifest: List[tuple]) -> Dict[str, Any]:
    """A follower: its slices of rank 0's tree, placed on its device. Every
    leaf is received even after a placement fails (rank 0 sends them all),
    then the first failure raises."""
    tree: Dict[str, Any] = {}
    err = None
    for path, shape, dtype in manifest:
        t = group.recv_tensor(shape, dtype)
        if err is not None:
            continue
        try:
            t = t.to(group.device)
        except Exception as e:
            err = e
            continue
        if len(path) == 1:
            tree[path[0]] = t
        else:
            tree.setdefault(path[0], {})[path[1]] = t
    if err is not None:
        raise err
    return tree


# -- followers -------------------------------------------------------------------
def build_rank_runner(group: TPGroup, kw: Dict[str, Any]):
    """This rank's ModelRunner for rank 0's build arguments: the rank's
    device, its slice of the params (drawn, received from rank 0's whole
    tree, or read from `checkpoint_dir`) and of the pools."""
    from dynamo_tpu_torch.engine import weights
    from dynamo_tpu_torch.engine.model_runner import ModelRunner

    kw = dict(kw)
    ckpt = kw.pop("checkpoint_dir", None)
    manifest = kw.pop("param_slices", None)
    kw["device"] = group.device
    if manifest is not None:
        kw["params"] = recv_param_slices(group, manifest)
    if ckpt is not None:
        kw["params"] = load_rank_checkpoint(group, ckpt, kw)
    return ModelRunner(**kw, tp=group)


def load_rank_checkpoint(group: TPGroup, ckpt: str, kw: Dict[str, Any]):
    """This rank's slices of an HF checkpoint directory: its model cut
    and, of the routed experts, only its own."""
    from dynamo_tpu_torch.engine import weights

    c, mesh = group.coords, group.mesh
    return weights.load_hf_checkpoint(
        ckpt, kw["config"], group.device, kw.get("dtype", torch.bfloat16),
        rank=c["model"], tp=mesh.model, ep_rank=c["expert"], ep=mesh.expert)


def _local_pools(runner) -> Dict[str, Any]:
    """This rank's KV pools as numpy (tests)."""
    def host(p):
        if isinstance(p, dict):
            return {k: v.cpu().numpy() for k, v in p.items()}
        return p.float().cpu().numpy()
    return {"k": host(runner.k_pool), "v": host(runner.v_pool)}


def follower_loop(group: TPGroup) -> None:
    """Run rank 0's calls on this rank until told to exit. After each
    runner call, build or attribute set the ranks trade its outcome: where
    they differ (diverged), this rank's state is no longer rank 0's, and
    the loop ends with SystemExit (the process exits non-zero)."""
    runner = None
    digest = Digest()
    while True:
        name, args, kw = group.recv_call()
        if name == "__exit__":
            return
        if name == "__close__":
            runner = group.runner = None
            gc.collect()
            if group.device.type == "cuda":
                torch.cuda.empty_cache()
            continue
        if name == "__reset__":
            reset_counters(runner)
            digest = Digest()
            continue
        if name == "__report__":
            group.gather_objects(rank_report(group.rank, runner, digest))
            continue
        if name == "__pools__":
            group.gather_objects(_local_pools(runner))
            continue
        if name == "__run__":  # a function on every rank (tests)
            import importlib

            mod, qual, fargs = args
            fn = importlib.import_module(mod)
            for part in qual.split("."):
                fn = getattr(fn, part)
            group.gather_objects(_run_one(group, fn, fargs))
            continue
        if name == "__modules__":  # what this rank has imported (tests)
            group.gather_objects(sorted(sys.modules))
            continue
        if name == "__layouts__":
            from dynamo_tpu_torch.runtime.sanitizer import layout_problems
            group.gather_objects(layout_problems(runner.layout_table()))
            continue
        err = None
        try:
            if name == "__build__":
                runner = group.runner = None
                digest = Digest()
                gc.collect()
                runner = group.runner = build_rank_runner(group, kw)
            elif name == "__set__":
                setattr(runner, *args)
            elif name == "__mesh__":
                runner = group.runner = None
                gc.collect()
                group.set_axes(*args)
            else:
                digest.fold(getattr(runner, name)(*args, **kw))
        except Exception as e:
            err = e
        outcomes = group.call_status(err)
        if diverged(outcomes):
            log.error("rank %d: %s left the ranks apart: %s", group.rank, name, outcomes)
            raise SystemExit(f"tensor-parallel rank {group.rank}: {name} left the "
                             f"ranks apart: {outcomes}")


def _follower_main(rank: int, size: int, store_path: str, device: str,
                   timeout_s: float, mesh: Optional[MeshConfig] = None) -> None:
    from dynamo_tpu_torch.runtime.logging_util import configure_logging

    configure_logging()
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    group = TPGroup(rank, size, store_path, device, timeout_s, mesh)
    try:
        follower_loop(group)
    finally:
        group.close()


def spawn_followers(size: int, device, timeout_s: float = DEFAULT_TIMEOUT_S,
                    mesh: Optional[MeshConfig] = None) -> Tuple[TPGroup, List[Any]]:
    """Start ranks 1..size-1 (spawned processes, daemonic: they end with
    this one) and join the group as rank 0, the world laid out as `mesh`
    (default: `size` tensor-parallel ranks). Returns (rank 0's group, the
    follower processes)."""
    import torch.multiprocessing as mp

    mesh = mesh or MeshConfig(model=size)
    d = tempfile.mkdtemp(prefix="dyn_tp_")
    init = os.path.join(d, "store")
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(1, size):
        p = ctx.Process(target=_follower_main, name=f"tp-rank{r}",
                        args=(r, size, init, str(torch.device(device)), timeout_s, mesh),
                        daemon=True)
        p.start()
        procs.append(p)
    try:
        group = TPGroup(0, size, init, device, timeout_s, mesh)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    log.info("%s: %d ranks on %s, transport %s", mesh.describe(), size,
             [str(d) for d in group.devices], group.transport)
    return group, procs


class FollowerWatch(threading.Thread):
    """Polls the followers' processes; calls `on_death(rank, exitcode)`
    once, for the first that is gone while the group is open."""

    def __init__(self, procs: Sequence[Any], on_death: Callable[[int, Any], None],
                 period_s: float = 0.5):
        super().__init__(name="tp-watch", daemon=True)
        self.procs = list(procs)
        self.on_death = on_death
        self.period_s = period_s
        self._stop = threading.Event()

    def run(self) -> None:
        while not self._stop.wait(self.period_s):
            for r, p in enumerate(self.procs, start=1):
                if not p.is_alive():
                    if not self._stop.is_set():
                        self.on_death(r, p.exitcode)
                    return

    def stop(self) -> None:
        self._stop.set()


# -- rank 0 ----------------------------------------------------------------------
class MirroredRunner:
    """Rank 0's runner on a parallel mesh: builds a ModelRunner on
    every rank from the same arguments, broadcasts each call of MIRRORED
    (and each attribute set) before running it here and checks that every
    rank's outcome agrees, reads the names of READ_ONLY from rank 0's own
    runner, and refuses every other runner attribute, naming the item that
    ports it (parallel/mesh.py). A given `params` tree is whole: each
    follower is sent its own slices (send_param_slices)."""

    def __init__(self, group: TPGroup, procs: Sequence[Any] = (), **runner_kw):
        from dynamo_tpu_torch.engine.model_runner import ModelRunner

        config = runner_kw["config"]
        check_tp(config, group.mesh, runner_kw)
        if group.device.type == "cuda":
            tp_check_fits(group.mesh, group.devices[0], runner_kw)
        object.__setattr__(self, "_group", group)
        object.__setattr__(self, "_procs", list(procs))
        object.__setattr__(self, "_lock", threading.RLock())
        object.__setattr__(self, "_digest", Digest())
        object.__setattr__(self, "_runner", None)
        object.__setattr__(self, "failed", None)
        params = runner_kw.get("params")
        build_kw = dict(runner_kw)
        if params is not None:
            build_kw["params"] = None
            build_kw["param_slices"] = slice_manifest(params, config, group.mesh)
        kw = dict(runner_kw)
        ckpt = kw.pop("checkpoint_dir", None)
        kw["device"] = group.device

        def build():
            if params is not None:
                send_param_slices(group, params, build_kw["param_slices"])
            if ckpt is not None:
                kw["params"] = load_rank_checkpoint(group, ckpt, kw)
            return ModelRunner(**kw, tp=group)

        with self._lock:
            self._check_alive()
            group.send_call("__build__", (), build_kw)
            object.__setattr__(self, "_runner", self._settled("__build__", build))
            group.runner = self._runner

    @property
    def group(self) -> TPGroup:
        return self._group

    @property
    def runner(self):
        return self._runner

    def __getattr__(self, name: str):
        attr = getattr(self._runner, name)  # AttributeError: not a runner's
        if name in MIRRORED:
            return lambda *a, **kw: self._mirror(name, attr, a, kw)
        if name in READ_ONLY:
            return attr
        raise refuse_tp(f"the runner's {name}", refused_call_item(name))

    def __setattr__(self, name: str, value) -> None:
        """Set on every rank's runner (a bucket list or a switch changes
        the shapes the next forward takes on each)."""
        with self._lock:
            self._check_alive()
            self._group.send_call("__set__", (name, value))
            self._settled("__set__", lambda: setattr(self._runner, name, value))

    def _mirror(self, name: str, fn, args: tuple, kw: dict):
        if kw.get("mask_fn") is not None:
            raise refuse_tp("guided decoding's host fallback (a mask computed on "
                            "the host between steps)", ITEM_HOST_STEPS)
        with self._lock:
            self._check_alive()
            self._group.send_call(name, args, kw)
            out = self._settled(name, lambda: fn(*args, **kw))
            self._digest.fold(out)
            return out

    def _settled(self, name: str, run: Callable[[], Any]):
        """run() here, then every rank's outcome of the call `name`: the
        result where every rank returned; rank 0's error where every rank
        raised the same; else the ranks are apart (diverged): RuntimeError
        naming each rank's outcome, and every later call refused."""
        err = None
        try:
            out = run()
        except Exception as e:
            err = e
        outcomes = self._group.call_status(err)
        if diverged(outcomes):
            object.__setattr__(self, "failed", list(enumerate(outcomes)))
            text = "; ".join(f"rank {r}: {o or 'returned'}" for r, o in enumerate(outcomes))
            raise RuntimeError(f"tensor-parallel ranks left apart by {name} ({text}); "
                               "the followers exit") from err
        if err is not None:
            raise err
        return out

    def import_pages_device(self, target_pages: List[int], offset: int, k, v) -> None:
        """Device-staged whole-head pages: through the host to every rank."""
        n = len(target_pages)
        self.import_page_tensors(target_pages, k[:, offset:offset + n].cpu(),
                                 v[:, offset:offset + n].cpu())

    def _check_alive(self) -> None:
        if self.failed is not None:
            raise RuntimeError(f"tensor-parallel ranks failed earlier: {self.failed}")
        dead = [(r, p.exitcode) for r, p in enumerate(self._procs, start=1)
                if not p.is_alive()]
        if dead:
            object.__setattr__(self, "failed", dead)
            raise RuntimeError(f"tensor-parallel followers gone (rank, exit code): {dead}")

    def rank_reports(self) -> List[Dict[str, Any]]:
        """Every rank's launch counts, bodies, runner counters, peak
        memory and digest of returned arrays, in rank order."""
        with self._lock:
            self._check_alive()
            self._group.send_call("__report__")
            return self._group.gather_objects(rank_report(0, self._runner, self._digest))

    def reset_counters(self) -> None:
        """Zero every rank's launch counts, counters, peak memory and
        digest."""
        with self._lock:
            self._check_alive()
            self._group.send_call("__reset__")
            reset_counters(self._runner)
            object.__setattr__(self, "_digest", Digest())

    def rank_layout_problems(self) -> List[Tuple[int, List[str]]]:
        """The followers' layout checks (runtime/sanitizer.py
        layout_problems of each one's own table): [(rows, problems)]."""
        with self._lock:
            self._check_alive()
            self._group.send_call("__layouts__")
            return self._group.gather_objects((0, []))[1:]

    def rank_pools(self) -> List[Dict[str, Any]]:
        """Every rank's KV pools as numpy, in rank order (tests)."""
        with self._lock:
            self._group.send_call("__pools__")
            return self._group.gather_objects(_local_pools(self._runner))

    def close(self) -> None:
        """Drop every rank's runner (the group and the followers stay)."""
        with self._lock:
            if (not self._group.closed and self.failed is None
                    and all(p.is_alive() for p in self._procs)):
                self._group.send_call("__close__")
            object.__setattr__(self, "_runner", None)
            self._group.runner = None
            gc.collect()


def tp_check_fits(mesh, device, runner_kw: Dict[str, Any]) -> None:
    """Before any rank draws or reads a tensor (and before the followers
    are spawned, where the caller checks then): every card's free memory
    against the bytes of all the ranks of `mesh` (an int: that many
    tensor-parallel ranks) it holds (each rank's params slice, its own
    experts' included, and its pools), MemoryError naming both. A given
    whole tree is already resident; each rank's slices of it are counted,
    as drawn ones (their transfer holds one slice on the host)."""
    from dynamo_tpu_torch.engine.weights import check_fits, serving_bytes

    mesh = as_mesh(mesh)
    c = runner_kw["config"]
    per_rank = serving_bytes(
        c, runner_kw.get("num_pages", 512), runner_kw.get("page_size", 16),
        runner_kw.get("dtype", torch.bfloat16), runner_kw.get("kv_quantize"),
        tp=mesh.model, ep=mesh.expert)
    size = mesh.n_devices
    devices = [rank_device(r, device) for r in range(size)]
    for dev in sorted(set(devices), key=str):
        check_fits(c.name, per_rank, torch.cuda.mem_get_info(dev)[0],
                   ranks=devices.count(dev), tp=size)


def shutdown_followers(group: TPGroup, procs: Sequence[Any], join_s: float = 30.0) -> List[Any]:
    """Tell the followers to exit, wait for them (killing any that stay
    past `join_s`), and close rank 0's group. Returns their exit codes."""
    if not group.closed and all(p.is_alive() for p in procs):
        try:
            group.send_call("__exit__")
        except Exception as e:
            log.warning("tensor-parallel shutdown: %s", e)
    end = time.monotonic() + join_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
    group.close()
    return [p.exitcode for p in procs]
