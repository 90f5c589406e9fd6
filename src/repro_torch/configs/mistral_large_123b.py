"""mistral-large-123b [dense]: 88L d12288 96H (kv=8) ff28672 v32768.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""
import dataclasses

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab=32768, head_dim=128, rope_theta=1e6,
    param_mode="fsdp", supports_long_context=False,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mistral-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    param_mode="replicated",
)
