"""glm4-9b — dense decoder, RoPE, extreme GQA (kv=2).

[hf:THUDM/glm-4-9b; hf]  40L d_model=4096 32H (kv=2) d_ff=13696
vocab=151552.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="glm4-9b", family="dense",
    n_layers=40, d_model=4096, vocab=151552,
    attn_type="gqa", n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696,
    tie_embeddings=False,
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, vocab=512, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128,
)
