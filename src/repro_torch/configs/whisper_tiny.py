"""whisper-tiny [audio] — enc-dec transformer backbone; the mel-spectrogram +
conv frontend is a STUB (input_specs provides precomputed frame embeddings)
[arXiv:2212.04356].  A copy of
``repro.configs.whisper_tiny``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    n_layers=4,             # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    act="gelu",
    n_audio_frames=1500,
    source="arXiv:2212.04356",
)
