"""PyTorch and CUDA port of ``repro``'s serving paths and training: every
family of its registry (dense, moe, ssm: RWKV-6, hybrid: RecurrentGemma,
audio: Whisper, vlm: LLaVA-NeXT), the paper's CNNs, the calibration bridge,
the KV-cache and int8 quantization utilities, the optimizer, data,
checkpoints and train step, and the sharded paths on a device mesh
(``shardctx.py``, ``launch/mesh.py``, ``launch/sharding.py``; see
ROADMAP.md).

The package imports ``torch`` and nothing of ``jax`` or ``repro``; its tests hold
it against the JAX package on the same weights and inputs.  Entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

# float32 matmuls and convolutions in full float32: TF32 keeps about three
# decimal digits, and the float32 parity bar against the reference (logits
# within 1e-5) depends on these staying off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  Raises, rather than falling back
    to the CPU, when the card is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
