"""zamba2-2.7b [hybrid]: 54 Mamba2 blocks d2560 (ssm_state=64) + ONE
shared transformer block (32H, ff10240) applied every 6 blocks with tied
weights. [arXiv:2411.15242; hf]
"""
import dataclasses

from repro_torch.models.config import LMConfig, SSMCfg

CONFIG = LMConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80, rope_theta=1e4,
    ssm=SSMCfg(d_state=64, d_conv=4, expand=2, n_groups=1, chunk=256,
               attn_every=6),
    param_mode="replicated", supports_long_context=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-smoke", n_layers=6, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, n_groups=1, chunk=16,
               attn_every=3),
)
