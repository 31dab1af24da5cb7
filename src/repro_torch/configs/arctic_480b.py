"""Snowflake Arctic (base): 128-expert top-2 MoE with a parallel dense
residual FFN.  [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    num_experts=128, experts_per_token=2, moe_dense_ff=4864,
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
