"""The weight-only quantized GEMM: y = x @ dequant(codes) with the
reference's roundings.

The reference's `mm` (dynamo_tpu/models/quant.py:41) leaves the product
to XLA, which fuses the dequantization into the matmul's operand load
("dequant fused by XLA"); there is no Pallas kernel to port. The port
must not dequantize a bf16 copy of each weight every step and hand it to
torch.matmul: that reads one byte, writes two and reads two again per
weight, more than the bf16 model reads. So the product has a hand-written
Hopper kernel of its own, csrc/quant_gemm.cu, which reads the one-byte
codes and builds the bf16 operands in registers.

    y[m, n] = bf16( bf16(sum_k x[m, k] w[k, n]) * bf16(s[n]) )

x is bf16 [..., K]; the codes int8 or float8_e4m3fn in one of two layouts:
- KN: [K, N] with scales [1, N], for `mm` (every matrix x @ W);
- NK: [N, K] with scales [N, 1], for `tied_logits` over the row-quantized
  embedding table (h @ embed^T).
The two roundings are the reference's (the product in x's dtype, then the
scale cast to x's dtype and multiplied). The sum runs in f32 in a fixed
order (no split K, no float atomics): a run repeats bit for bit.

`quant_matmul` launches the kernel on CUDA tensors (bf16 x; a failed build
or launch raises) and runs `quant_matmul_ref`, the plain version, on CPU
tensors in any float dtype; chip_smoke.py holds the kernel against the
plain version on the card. `quant_matmul.launches` counts launches and
`quant_matmul.bodies` counts them by layout and code type ("kn_int8",
"nk_fp8", ...). The weights never change, so what the kernel needs of
them (code and scale types, shapes, contiguity, alignment, its K and N
granules) is checked once, by `check_weight`, where a tree is built
(models/quant.py `check_tree`); a call checks only x against them.
`mm_ref` is the plain product of x with a plain or a quantized weight.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops import _build

# the kernel's K and column granules: K a multiple of QGEMM_BK (the depth
# of a prefill stage), N of QGEMM_N_ALIGN (a warp's columns)
QGEMM_BK = 64
QGEMM_N_ALIGN = 32
# rows of x at or below which a launch takes the tiles whose warps split K
# (16 or 64 rows x 32 columns: decode and the small ragged buckets, K a
# multiple of 256), above which the 128 x 64 tiles
QGEMM_SMALL_M = 64
CODE_TYPES = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
# a launch's body by (layout is NK, code type)
_BODIES = {(nk, dt): f"{'nk' if nk else 'kn'}_{code}"
           for nk in (False, True) for dt, code in CODE_TYPES.items()}


def is_quantized_weight(w) -> bool:
    """A weight-only quantized matrix (or stack): {"q": codes, "s": scales}."""
    return isinstance(w, dict) and "q" in w and "s" in w


def quant_matmul_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     nk: bool = False) -> torch.Tensor:
    """The reference's `mm` (KN: codes [..., K, N], scales [..., 1, N])
    and `tied_logits` (nk: codes [N, K], scales [N, 1]), in x's dtype."""
    if nk:
        return (x @ q.T.to(x.dtype)) * s[:, 0].to(x.dtype)
    return (x @ q.to(x.dtype)) * s.to(x.dtype)


def mm_ref(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain or a quantized weight [..., in, out] (a stack of
    them too): the reference's `mm`, in plain PyTorch."""
    if is_quantized_weight(w):
        return quant_matmul_ref(x, w["q"], w["s"])
    return x @ w


def weight_at(w, i: int):
    """Matrix i of a stack of plain or quantized weights (each leaf of a
    quantized one sliced)."""
    if isinstance(w, dict):
        return {k: v[i] for k, v in w.items()}
    return w[i]


def check_weight(q: torch.Tensor, s: torch.Tensor, nk: bool = False) -> None:
    """Raise unless the kernel takes these codes and scales: KN codes
    [..., K, N] with scales [..., 1, N] (a stack: each matrix in turn), or
    NK codes [N, K] with scales [N, 1]; int8 or e4m3 codes, f32 scales, on
    one device, contiguous and 16-byte aligned (so is each matrix of a
    stack, K N being a multiple of 16), K a multiple of QGEMM_BK and N of
    QGEMM_N_ALIGN."""
    if nk and q.dim() != 2 or q.dim() < 2:
        raise ValueError(f"quant_matmul: codes {tuple(q.shape)} are not a matrix")
    N, K = q.shape if nk else q.shape[:-3:-1]
    want_s = (N, 1) if nk else (*q.shape[:-2], 1, N)
    if tuple(s.shape) != want_s:
        raise ValueError(f"quant_matmul: codes {tuple(q.shape)}, scales "
                         f"{tuple(s.shape)} ({'NK' if nk else 'KN'})")
    if q.dtype not in CODE_TYPES:
        raise TypeError(f"quant_matmul takes int8 or float8_e4m3fn codes, not {q.dtype}")
    if s.dtype != torch.float32:
        raise TypeError(f"quant_matmul takes f32 scales, not {s.dtype}")
    if s.device != q.device:
        raise ValueError(f"quant_matmul: scales on {s.device}, codes on {q.device}")
    for name, t in (("codes", q), ("scales", s)):
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul takes contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"quant_matmul: {name} are not 16-byte aligned")
    if K % QGEMM_BK or N % QGEMM_N_ALIGN:
        raise ValueError(f"quant_matmul: no kernel for K={K}, N={N} (K % {QGEMM_BK} "
                         f"and N % {QGEMM_N_ALIGN} must be 0)")


def quant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 nk: bool = False) -> torch.Tensor:
    """x [..., K] @ the quantized weight -> [..., N] in x's dtype (see the
    module docstring for the layouts). On CUDA tensors the weight must
    have passed `check_weight`; x is checked here."""
    if x.device.type == "cpu":
        return quant_matmul_ref(x, q, s, nk)
    if q.dim() != 2:
        raise ValueError(f"quant_matmul: codes {tuple(q.shape)} are not a matrix")
    N, K = q.shape if nk else q.shape[::-1]
    if x.shape[-1] != K:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)}, codes {tuple(q.shape)} "
                         f"({'NK' if nk else 'KN'})")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"quant_matmul takes bf16 x, not {x.dtype}")
    if x.device != q.device:
        raise ValueError(f"quant_matmul: codes on {q.device}, x on {x.device}")
    # a call's host time adds up over a decode step's hundreds of
    # products: no reshapes, the rows of x as they lie
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.contiguous()
    M = x.numel() // K
    y = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    body = _BODIES[bool(nk), q.dtype]
    lib = _build.load()["quant_gemm"]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.quant_gemm(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                        M, N, K, int(nk), int(q.dtype == torch.float8_e4m3fn), stream)
    _build.check(lib, rc, "quant_matmul")
    quant_matmul.launches += 1
    quant_matmul.bodies[body] = quant_matmul.bodies.get(body, 0) + 1
    return y


quant_matmul.launches = 0
quant_matmul.bodies = {}
