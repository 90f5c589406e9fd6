"""gemma3-12b [dense]: 48L d3840 16H (kv=8) ff15360 v262144; 5:1
local:global sliding-window attention (window 1024), tied embeddings,
qk-norm, 128k context. [hf:google/gemma-3-1b-pt; unverified]
"""
import dataclasses

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262144, head_dim=240,
    window=1024, local_global=(5, 1), qk_norm=True,
    rope_theta=1e4, rope_theta_global=1e6,
    tie_embed=True, embed_scale=True, act="gelu",
    param_mode="fsdp", supports_long_context=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-12b-smoke", n_layers=12, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, window=8,
    param_mode="replicated",
)
