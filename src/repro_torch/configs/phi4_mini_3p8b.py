"""phi4-mini-3.8b — dense decoder, RoPE + SwiGLU + GQA.

[arXiv:2412.08905; hf]  32L d_model=3072 24H (kv=8) d_ff=8192
vocab=200064; tied embeddings.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, vocab=200064,
    attn_type="gqa", n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, vocab=512, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128,
)
