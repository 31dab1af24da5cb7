"""LLaVA-NeXT-34B backbone: Yi-34B-shaped LM with anyres vision tiling
stubbed -- input_specs provides patch/soft-token embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    frontend="vision", frontend_tokens=576,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
