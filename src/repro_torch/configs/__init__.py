"""Scenario tables and architectures (port of ``repro.configs``): the
paper's MicroHH grids (``microhh``) and every LM architecture of the
reference (the dense family, MoE, MoE with MLA, vision, mamba+attn, RWKV
and the encoder-decoder), one module per architecture, each exporting
``CONFIG``.

``get_arch("codeqwen1.5-7b")`` returns the full config;
``get_arch(name).reduced()`` the CPU smoke variant. ``list_archs()`` lists
the reference's architectures, which the launcher's and the roofline's
tables cover; ``get_arch`` also knows the port's own
(:data:`PORT_ARCH_MODULES`: deepseek-v2-lite, which the reference lacks).
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
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "whisper-base": "repro_torch.configs.whisper_base",
}

#: Architectures the port runs and the reference does not have.
PORT_ARCH_MODULES: dict[str, str] = {
    "deepseek-v2-lite": "repro_torch.configs.deepseek_v2_lite",
}


def get_arch(name: str) -> ArchConfig:
    modules = {**ARCH_MODULES, **PORT_ARCH_MODULES}
    if name not in modules:
        raise KeyError(f"unknown arch {name!r}; have {sorted(modules)}")
    return importlib.import_module(modules[name]).CONFIG


def list_archs() -> list[str]:
    return sorted(ARCH_MODULES)
