"""gemma3-1b [dense]: 26L d1152 4H (kv=1, MQA) ff6912 v262144; 5:1
local:global (window 1024), tied embeddings, qk-norm.
[hf:google/gemma-3-1b-pt; unverified]
"""
import dataclasses

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab=262144, head_dim=288,
    window=1024, local_global=(5, 1), qk_norm=True,
    rope_theta=1e4, rope_theta_global=1e6,
    tie_embed=True, embed_scale=True, act="gelu",
    param_mode="replicated", supports_long_context=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-1b-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab=256, head_dim=16, window=8,
)
