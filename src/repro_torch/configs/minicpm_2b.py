"""MiniCPM-2B: llama-like dense (WSD schedule lives in repro.optim).
[arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753,
    source="arXiv:2404.06395; hf",
)
