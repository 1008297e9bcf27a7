"""Batched KV page copies: gather pages out of a paged pool (optionally
transposed to head-major), scatter dense pages into pool slots, and the
layer-group scatter of the layer-streamed onboard.

Port of dynamo_tpu/ops/block_copy.py `gather_pages`, `scatter_pages` and
`scatter_pages_layers`. On CUDA tensors each wrapper checks its operands
and launches the hand-written Hopper kernel in csrc/block_copy.cu; on CPU
tensors it runs the plain PyTorch version beside it (advanced indexing, a
transpose, `index_copy_`), which is also what the kernels are held against.
The scatters write into the pool tensor in place, the counterpart of the
reference's donated, aliased output. The `*_sharded` wrappers wait for
tensor parallelism.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dynamo_tpu_torch.ops import _build

# the kernels move bytes: any of these element types, 16-byte vectors
# (int8: the codes of an int8 KV pool; its f32 scales go as float32)
_DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.int8)


def gather_pages_ref(pool: torch.Tensor, idx: torch.Tensor, *,
                     head_major: bool = False) -> torch.Tensor:
    stacked = pool.dim() == 5
    out = (pool if stacked else pool[None])[:, idx.long()]
    if head_major:
        out = out.transpose(2, 3).contiguous()
    return out if stacked else out[0]


def scatter_pages_ref(pool: torch.Tensor, idx: torch.Tensor,
                      pages: torch.Tensor) -> torch.Tensor:
    pool.index_copy_(pool.dim() - 4, idx.long(), pages)
    return pool


def scatter_pages_layers_ref(pool: torch.Tensor, idx: torch.Tensor,
                             pages: torch.Tensor,
                             layer_off: torch.Tensor) -> torch.Tensor:
    lo = int(layer_off[0])
    pool[lo:lo + pages.shape[0]].index_copy_(1, idx.long(), pages)
    return pool


def _check(pool: torch.Tensor, idx: torch.Tensor, *others: torch.Tensor,
           whole_pages: bool = False) -> None:
    """Operands a kernel takes: one CUDA device, contiguous, 16-byte
    aligned, a supported element type, int32 page ids, D rows a whole
    number of 16-byte vectors. `whole_pages` (a copy that never splits a
    page into its rows: token-major gathers, both scatters, head-major with
    one KV head) asks only that a whole page be one: MLA's 1-wide stub
    pool has 2-byte rows in 32-byte pages."""
    if pool.dtype not in _DTYPES:
        raise TypeError(f"no page-copy kernel for {pool.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("page ids must be a 1-D int32 tensor")
    tensors = (pool, idx) + others
    if any(t.device != pool.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the page-copy kernels take contiguous operands")
    if any(t.data_ptr() % 16 for t in (pool,) + others if t.dtype == pool.dtype):
        raise ValueError("pool and pages must be 16-byte aligned")
    if whole_pages:
        if math.prod(pool.shape[-3:]) * pool.element_size() % 16:
            raise ValueError(f"pages of {tuple(pool.shape[-3:])} x "
                             f"{pool.element_size()} bytes are not whole "
                             "16-byte vectors")
    elif pool.shape[-1] * pool.element_size() % 16:
        raise ValueError(f"D rows of {pool.shape[-1]} x {pool.element_size()} "
                         "bytes are not whole 16-byte vectors")


def _check_ids(idx: torch.Tensor, NP: int, unique: bool,
               layer_off: Optional[torch.Tensor] = None, L: int = 0,
               Lg: int = 0) -> None:
    """Page ids in [0, NP), unique for a scatter, and a layer group inside
    the pool: one readback for all of it."""
    s = idx.sort().values
    vals = [s[0], s[-1]]
    if unique:
        vals.append((s[1:] == s[:-1]).sum())
    if layer_off is not None:
        vals.append(layer_off[0])
    got = torch.stack([v.long() for v in vals]).tolist()
    if got[0] < 0 or got[1] >= NP:
        raise ValueError(f"page ids span [{got[0]}, {got[1]}], pool has {NP}")
    if unique and got[2]:
        raise ValueError("scatter page ids must be unique")
    if layer_off is not None and not 0 <= got[-1] <= L - Lg:
        raise ValueError(f"layer group [{got[-1]}, {got[-1] + Lg}) outside "
                         f"the pool's {L} layers")


def gather_pages(
    pool: torch.Tensor,  # [NP, PS, Hk, D] one layer OR [L, NP, PS, Hk, D]
    idx: torch.Tensor,  # [n] int32 page ids
    *,
    head_major: bool = False,
) -> torch.Tensor:
    """Copy pages `idx` out of the pool into a new dense buffer:
    [(L,) n, PS, Hk, D] (token-major) or [(L,) n, Hk, PS, D]
    (head_major=True). A stacked pool takes the same page list in every
    layer."""
    if pool.device.type == "cpu":
        return gather_pages_ref(pool, idx, head_major=head_major)
    stacked = pool.dim() == 5
    L, NP, PS, Hk, D = pool.shape if stacked else (1,) + tuple(pool.shape)
    n = idx.shape[0]
    _check(pool, idx, whole_pages=not head_major or Hk == 1)
    page = (Hk, PS, D) if head_major else (PS, Hk, D)
    out = torch.empty(((L,) if stacked else ()) + (n,) + page,
                      dtype=pool.dtype, device=pool.device)
    if n == 0:
        return out
    _check_ids(idx, NP, unique=False)
    _launch_gather(pool, idx, out, head_major)
    gather_pages.launches += 1
    return out


def scatter_pages(
    pool: torch.Tensor,  # [(L,) NP, PS, Hk, D], updated in place
    idx: torch.Tensor,  # [n] int32 target page ids (unique)
    pages: torch.Tensor,  # [(L,) n, PS, Hk, D] token-major pages
) -> torch.Tensor:
    """Write dense pages into pool slots `idx`, in place; returns the
    pool. Pages the call does not name stay as they were."""
    if pool.device.type == "cpu":
        return scatter_pages_ref(pool, idx, pages)
    stacked = pool.dim() == 5
    L, NP, PS, Hk, D = pool.shape if stacked else (1,) + tuple(pool.shape)
    n = idx.shape[0]
    want = ((L,) if stacked else ()) + (n, PS, Hk, D)
    if tuple(pages.shape) != want or pages.dtype != pool.dtype:
        raise ValueError(f"pages {tuple(pages.shape)} {pages.dtype} do not "
                         f"match {want} {pool.dtype}")
    _check(pool, idx, pages, whole_pages=True)
    if n == 0:
        return pool
    _check_ids(idx, NP, unique=True)
    _launch_scatter(pool, idx, pages)
    scatter_pages.launches += 1
    return pool


def scatter_pages_layers(
    pool: torch.Tensor,  # [L, NP, PS, Hk, D], updated in place
    idx: torch.Tensor,  # [n] int32 target page ids (unique)
    pages: torch.Tensor,  # [Lg, n, PS, Hk, D] one layer group of pages
    layer_off: torch.Tensor,  # [1] int32: first pool layer of the group
) -> torch.Tensor:
    """Write a layer-group slab into pool layers [layer_off, layer_off+Lg)
    at slots `idx`, in place; returns the pool. The streamed onboard calls
    it once per group."""
    if pool.device.type == "cpu":
        return scatter_pages_layers_ref(pool, idx, pages, layer_off)
    L, NP, PS, Hk, D = pool.shape
    Lg, n = pages.shape[:2]
    if tuple(pages.shape[2:]) != (PS, Hk, D) or pages.dtype != pool.dtype:
        raise ValueError(f"pages {tuple(pages.shape)} {pages.dtype} do not "
                         f"match the pool's pages {(PS, Hk, D)} {pool.dtype}")
    if layer_off.dtype != torch.int32 or layer_off.numel() != 1:
        raise TypeError("layer_off must be a [1] int32 tensor")
    _check(pool, idx, pages, layer_off, whole_pages=True)
    if n == 0:
        return pool
    _check_ids(idx, NP, unique=True, layer_off=layer_off, L=L, Lg=Lg)
    _launch_scatter(pool, idx, pages, layer_off)
    scatter_pages_layers.launches += 1
    return pool


# -- launches of checked operands (the wrappers count them) ------------------
def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_gather(pool, idx, out, head_major: bool) -> None:
    L, NP, PS, Hk, D = pool.shape if pool.dim() == 5 else (1,) + tuple(pool.shape)
    if not head_major or Hk == 1:
        # a plain page copy (the head-major transpose of one KV head moves
        # nothing): the kernel sees each page as one row of 16-byte vectors
        PS, Hk, D, head_major = 1, 1, PS * Hk * D, False
    lib = _build.load()["block_copy"]
    rc = lib.gather_pages(
        pool.data_ptr(), idx.data_ptr(), out.data_ptr(), L, NP, idx.shape[0],
        PS, Hk, D * pool.element_size() // 16, int(head_major), _stream(pool))
    _build.check(lib, rc, "gather_pages")


def _launch_scatter(pool, idx, pages, layer_off=None) -> None:
    """scatter_pages (layer_off None: pages span every pool layer) or
    scatter_pages_layers (pages are the group at layer_off)."""
    NP = pool.shape[-4]
    page_vecs = math.prod(pool.shape[-3:]) * pool.element_size() // 16
    Lg = pages.shape[0] if pages.dim() == 5 else 1
    lib = _build.load()["block_copy"]
    if layer_off is None:
        rc = lib.scatter_pages(pool.data_ptr(), idx.data_ptr(), pages.data_ptr(),
                               Lg, NP, idx.shape[0], page_vecs, _stream(pool))
    else:
        rc = lib.scatter_pages_layers(
            pool.data_ptr(), idx.data_ptr(), layer_off.data_ptr(),
            pages.data_ptr(), Lg, NP, idx.shape[0], page_vecs, _stream(pool))
    _build.check(lib, rc, "scatter_pages" if layer_off is None
                 else "scatter_pages_layers")


gather_pages.launches = 0
scatter_pages.launches = 0
scatter_pages_layers.launches = 0
