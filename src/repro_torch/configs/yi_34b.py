"""yi-34b — llama-arch dense decoder with GQA.

[arXiv:2403.04652; hf]  60L d_model=7168 56H (kv=8) d_ff=20480
vocab=64000, rope theta 5e6.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-34b", family="dense",
    n_layers=60, d_model=7168, vocab=64000,
    attn_type="gqa", n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, rope_theta=5e6,
    tie_embeddings=False,
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, vocab=512, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128,
)
