"""Config registry: get_config(name) for the 10 assigned archs, plus
reduced smoke variants (same family, tiny dims) for CPU tests.

The model configs of src/repro/configs/__init__.py, and from configs/spdc.py
the SPDC protocol's presets (`SPDCConfig`, `SPDC_*`), the rateless
dispatch knobs (`RatelessConfig`, `RATELESS_DEFAULT`) and the gateway's
configs (`SPDCGatewayConfig`, `SPDC_GATEWAY_*`, `AdmissionConfig`,
`BreakerConfig`, `CacheConfig` and their presets).
"""
from __future__ import annotations

from dataclasses import replace

from .base import SHAPES, ModelConfig, ShapeConfig, cell_status, runnable_cells
from .gemma3_1b import GEMMA3_1B
from .gemma_2b import GEMMA_2B
from .granite_moe_1b_a400m import GRANITE_MOE_1B
from .hubert_xlarge import HUBERT_XLARGE
from .jamba_1_5_large_398b import JAMBA_1_5_LARGE
from .llama4_scout_17b_a16e import LLAMA4_SCOUT
from .mamba2_370m import MAMBA2_370M
from .nemotron_4_340b import NEMOTRON_4_340B
from .qwen2_vl_72b import QWEN2_VL_72B
from .spdc import (
    ADMISSION_OFF, BREAKER_DEFAULT, BREAKER_OFF, CACHE_DEFAULT, CACHE_OFF,
    RATELESS_DEFAULT, SPDC_DEFAULT, SPDC_EDGE_F32, SPDC_EDGE_HARDENED,
    SPDC_EDGE_MP, SPDC_EDGE_RATELESS, SPDC_EDGE_SMALL, SPDC_EDGE_SOCKET,
    SPDC_EDGE_THREADS, SPDC_GATEWAY_BULK, SPDC_GATEWAY_DEFAULT,
    SPDC_GATEWAY_F32, SPDC_GATEWAY_HARDENED, SPDC_GATEWAY_LOWLAT,
    SPDC_GATEWAY_PROD, SPDC_GATEWAY_SOCKET, SPDC_GATEWAY_THREADS, SPDC_POD,
    AdmissionConfig, BreakerConfig, CacheConfig, RatelessConfig,
    SPDCConfig, SPDCGatewayConfig,
)
from .tinyllama_1_1b import TINYLLAMA_1_1B

CONFIGS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        MAMBA2_370M, GEMMA_2B, NEMOTRON_4_340B, TINYLLAMA_1_1B, GEMMA3_1B,
        GRANITE_MOE_1B, LLAMA4_SCOUT, JAMBA_1_5_LARGE, QWEN2_VL_72B,
        HUBERT_XLARGE,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: 1–2 periods, tiny dims, CPU-runnable."""
    cfg = get_config(name)
    plen = len(cfg.pattern)
    small = dict(
        num_layers=min(2 * plen + (1 if cfg.num_layers % plen else 0), cfg.num_layers),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 256),
        activation_dtype="float32",
        params_dtype="float32",
        grad_accum=1,
    )
    if cfg.num_heads:
        small.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2), head_dim=16)
    if cfg.num_experts:
        small.update(num_experts=4, experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.ssm_heads:
        small.update(ssm_heads=4, ssm_head_dim=32, ssm_state=16, ssm_chunk=8)
    if cfg.window:
        small.update(window=16)
    return replace(cfg, name=cfg.name + "-smoke", **small)


__all__ = [
    "CONFIGS", "get_config", "smoke_config", "SHAPES", "ModelConfig",
    "ShapeConfig", "cell_status", "runnable_cells",
    "SPDCConfig", "SPDC_DEFAULT", "SPDC_EDGE_F32", "SPDC_EDGE_HARDENED",
    "SPDC_EDGE_MP", "SPDC_EDGE_RATELESS", "SPDC_EDGE_SMALL",
    "SPDC_EDGE_SOCKET", "SPDC_EDGE_THREADS", "SPDC_POD",
    "RatelessConfig", "RATELESS_DEFAULT",
    "SPDCGatewayConfig", "SPDC_GATEWAY_DEFAULT", "SPDC_GATEWAY_LOWLAT",
    "SPDC_GATEWAY_BULK", "SPDC_GATEWAY_HARDENED", "SPDC_GATEWAY_F32",
    "SPDC_GATEWAY_THREADS", "SPDC_GATEWAY_SOCKET", "SPDC_GATEWAY_PROD",
    "AdmissionConfig", "ADMISSION_OFF", "BreakerConfig", "BREAKER_DEFAULT",
    "BREAKER_OFF", "CacheConfig", "CACHE_DEFAULT", "CACHE_OFF",
]
