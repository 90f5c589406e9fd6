"""xlstm-350m [ssm]: 24 blocks d1024, 4 heads, 7:1 mLSTM:sLSTM, d_ff=0
(feed-forward lives in the mLSTM up/down projections).
[arXiv:2405.04517; unverified]
"""
import dataclasses

from repro_torch.models.config import LMConfig, XLSTMCfg

CONFIG = LMConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304,
    xlstm=XLSTMCfg(m_per_s=7, proj_factor=2.0, conv_kernel=4),
    param_mode="replicated", supports_long_context=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=4, vocab=256,
    xlstm=XLSTMCfg(m_per_s=3, proj_factor=2.0, conv_kernel=4),
)
