"""Whisper-medium backbone: encoder-decoder; conv audio frontend is a
stub (input_specs provides frame embeddings).  [arXiv:2212.04356;
unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=4096, vocab_size=51865,
    frontend="audio",
    source="arXiv:2212.04356; unverified",
)
