"""dynamo_tpu_torch: the PyTorch and CUDA port of dynamo_tpu for an NVIDIA
H100.

The package mirrors dynamo_tpu's module names (models/, ops/, engine/,
worker.py) so each counterpart is easy to find. It imports torch and never
JAX or dynamo_tpu. Entry points run on CUDA unless the caller passes
device="cpu"; the attention and page-copy ops run hand-written Hopper
kernels on CUDA tensors and their plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. With no card and no explicit "cpu" this raises rather than
    quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # an explicit index: the engine's step thread selects it by index
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
