"""arctic-480b [moe]: 35L d7168 56H (kv=8) ff4864 v32000, MoE 128e top-2
+ dense residual MLP in parallel (Snowflake Arctic dense-MoE hybrid).
[hf:Snowflake/snowflake-arctic-base; hf]
"""
import dataclasses

from repro_torch.models.config import LMConfig, MoECfg

CONFIG = LMConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_dim=128, rope_theta=1e4,
    moe=MoECfg(n_experts=128, top_k=2, d_expert=4864,
               dense_residual_ff=4864, capacity_factor=1.25,
               group_tokens=1024),
    param_mode="fsdp", supports_long_context=False,
)

SMOKE = dataclasses.replace(
    CONFIG, name="arctic-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab=256, head_dim=16,
    moe=MoECfg(n_experts=8, top_k=2, d_expert=96, dense_residual_ff=96,
               capacity_factor=1.5, group_tokens=32),
    param_mode="replicated",
)
