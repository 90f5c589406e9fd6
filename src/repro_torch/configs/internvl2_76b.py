"""internvl2-76b [vlm]: 80L d8192 64H (kv=8) ff28672 v128256; InternViT
frontend is a STUB (precomputed patch embeddings at d_model).
[arXiv:2404.16821; unverified]
"""
import dataclasses

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, head_dim=128, rope_theta=5e5,
    n_patches=256,
    param_mode="fsdp", supports_long_context=False,
)

SMOKE = dataclasses.replace(
    CONFIG, name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, n_patches=8,
    param_mode="replicated",
)
