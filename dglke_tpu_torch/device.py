"""Device selection shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when the card is asked for (or defaulted to) and
    there is none; never drops to the CPU.  On the card, fp32 matmuls and
    convolutions are held to full fp32 (no TF32): eval tie handling relies
    on full-precision scores."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dglke_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' (CLI: --device cpu) to run "
                "the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
