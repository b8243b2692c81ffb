"""Architecture registry of the port: the architectures it can serve so far."""
from __future__ import annotations

from repro_torch.configs import deepseek_7b, rwkv6_1p6b
from repro_torch.configs.base import ArchSpec

ARCHS: dict[str, ArchSpec] = {s.arch_id: s for s in (deepseek_7b.SPEC, rwkv6_1p6b.SPEC)}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"architecture {arch_id!r} is not ported yet; the port "
                       f"serves {sorted(ARCHS)} (the rest: ROADMAP.md Queue 1)")
    return ARCHS[arch_id]
