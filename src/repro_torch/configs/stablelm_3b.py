"""stablelm-3b [dense]: 32L d2560 32H (MHA) ff6912 v50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
import dataclasses

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab=50304, head_dim=80, rope_theta=1e4,
    param_mode="replicated", supports_long_context=False,
)

SMOKE = dataclasses.replace(
    CONFIG, name="stablelm-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
)
