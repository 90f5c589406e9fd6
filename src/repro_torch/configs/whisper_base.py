"""whisper-base [audio]: enc-dec, 6L+6L d512 8H ff2048 v51865; conv
frontend is a STUB (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]
"""
import dataclasses

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, head_dim=64, act="gelu",
    encoder_layers=6, encoder_frames=1500, frontend_dim=80,
    param_mode="replicated", supports_long_context=False,
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
    encoder_layers=2, encoder_frames=32, frontend_dim=16,
)
