"""RecurrentGemma-9B: RG-LRU + local attention hybrid, 1 local-attn
block per 2 recurrent blocks; MQA (kv=1), window 2048.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"), local_window=2048,
    source="arXiv:2402.19427; unverified",
)
