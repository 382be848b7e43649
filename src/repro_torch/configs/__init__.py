"""Scenario tables and architectures (port of ``repro.configs``): the
paper's MicroHH grids (``microhh``) and the LM architectures the port can
build (the dense family, MoE, MoE with MLA, and vision), one module per
architecture, each exporting ``CONFIG``.

``get_arch("codeqwen1.5-7b")`` returns the full config;
``get_arch(name).reduced()`` the CPU smoke variant. The reference's other
architectures (mamba+attn, RWKV, encoder-decoder) need model families the
port does not have yet; asking for one raises ``NotImplementedError``
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_MODULES: dict[str, str] = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
}

#: The reference's architectures that the port cannot build yet, and the
#: ROADMAP.md item (queue 1) that ports each.
NOT_PORTED: dict[str, str] = {
    "hymba-1.5b": "item 9 (mamba+attn)",
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
