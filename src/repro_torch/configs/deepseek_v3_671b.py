"""deepseek-v3-671b [moe]: 61L d7168 128H MLA, ff(expert)=2048 v129280,
MoE 1 shared + 256 routed top-8, 3 leading dense layers (ff 18432), MTP.
[arXiv:2412.19437; hf]
"""
import dataclasses

from repro_torch.models.config import LMConfig, MLACfg, MoECfg

CONFIG = LMConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab=129280, head_dim=128, rope_theta=1e4,
    moe=MoECfg(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
               first_dense=3, dense_ff=18432, capacity_factor=1.25,
               group_tokens=1024),
    mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
               qk_rope_head_dim=64, v_head_dim=128),
    mtp=True,
    param_mode="fsdp", supports_long_context=False,
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=64, vocab=256, head_dim=16,
    moe=MoECfg(n_experts=8, top_k=2, d_expert=64, n_shared=1,
               first_dense=1, dense_ff=128, capacity_factor=1.5,
               group_tokens=32),
    mla=MLACfg(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16),
    param_mode="replicated",
)
