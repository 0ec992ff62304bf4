"""whisper-small [audio] — enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, encoder_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab=51865,
    audio_frames=1500, act="gelu",
    source="arXiv:2212.04356; unverified",
)


def smoke() -> ModelConfig:
    return CONFIG.with_overrides(
        num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab=256, audio_frames=16,
        loss_chunk=16, remat="none")
