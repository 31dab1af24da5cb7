"""Falcon-Mamba-7B: attention-free Mamba-1 stack.
[arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024, ssm_state=16,
    source="arXiv:2410.05355; unverified",
)
