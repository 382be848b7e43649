"""Scenario tables and architectures (port of ``repro.configs``): the
paper's MicroHH grids (``microhh``) and the LM architectures the port can
build, one module per architecture, each exporting ``CONFIG``.

``get_arch("codeqwen1.5-7b")`` returns the full config;
``get_arch(name).reduced()`` the CPU smoke variant. The reference's other
architectures need model families the port does not have yet; asking for
one raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_MODULES: dict[str, str] = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
}

#: The reference's architectures that the port cannot build yet, and the
#: ROADMAP.md item (queue 1) that ports each.
NOT_PORTED: dict[str, str] = {
    "llama-3.2-vision-11b": "item 8 (vision: cross-attention)",
    "hymba-1.5b": "item 9 (mamba+attn)",
    "deepseek-moe-16b": "item 9 (MoE)",
    "deepseek-v2-236b": "item 9 (MoE with MLA)",
    "rwkv6-7b": "item 9 (RWKV)",
    "whisper-base": "item 9 (encoder-decoder)",
}


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP.md queue 1 "
            f"{NOT_PORTED[name]}")
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[name]).CONFIG


def list_archs() -> list[str]:
    return sorted(ARCH_MODULES)
