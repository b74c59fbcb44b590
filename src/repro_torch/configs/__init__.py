"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

Ten assigned architectures + the paper-analog workload config.  Every
entry exposes the exact published shape; ``reduced(cfg)`` gives the
smoke-test variant (same family & pattern, tiny dims).
"""
from .base import (
    DEFAULT_SCHED,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    LayerGroup,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RecurrentConfig,
    SchedConfig,
    ShapeConfig,
    reduced,
)

from .mistral_large_123b import CONFIG as _mistral
from .deepseek_coder_33b import CONFIG as _dscoder
from .minicpm_2b import CONFIG as _minicpm
from .phi3_mini_3_8b import CONFIG as _phi3
from .deepseek_v2_236b import CONFIG as _dsv2
from .llama4_maverick_400b import CONFIG as _llama4
from .musicgen_large import CONFIG as _musicgen
from .recurrentgemma_2b import CONFIG as _rgemma
from .xlstm_1_3b import CONFIG as _xlstm
from .qwen2_vl_7b import CONFIG as _qwen2vl

_REGISTRY: dict[str, ModelConfig] = {
    c.arch_id: c
    for c in (
        _mistral, _dscoder, _minicpm, _phi3, _dsv2,
        _llama4, _musicgen, _rgemma, _xlstm, _qwen2vl,
    )
}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch '{arch_id}'; available: {sorted(_REGISTRY)}"
        ) from None


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, with long_500k gated to the
    sub-quadratic archs (DESIGN.md §5)."""
    out = []
    for arch in list_archs():
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            out.append((arch, shape))
    return out


def skipped_cells() -> list[tuple[str, str, str]]:
    """(arch, shape, reason) for the documented skips in the 40-cell table."""
    out = []
    for arch in list_archs():
        if arch not in LONG_CONTEXT_ARCHS:
            out.append((arch, "long_500k",
                        "pure full-attention arch: 524k decode skipped per "
                        "assignment; see DESIGN.md §5"))
    return out


__all__ = [
    "DEFAULT_SCHED", "LONG_CONTEXT_ARCHS", "SHAPES", "LayerGroup",
    "MLAConfig", "ModelConfig", "MoEConfig", "RecurrentConfig", "SchedConfig",
    "ShapeConfig", "reduced", "get_config", "list_archs", "cells",
    "skipped_cells",
]
