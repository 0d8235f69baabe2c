"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8, per the
assignment) d_ff(expert)=2048 vocab=163840; MoE: 1 shared + 384 routed
experts, top-8; first layer dense (d_ff 18432).  head_dim=128 chosen
explicitly (MXU-aligned; the assignment gives no head_dim).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, vocab=163840,
    attn_type="gqa", n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=18432, dense_d_ff=18432, first_dense_layers=1,
    n_experts=384, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    tie_embeddings=False,
)

TINY = CONFIG.replace(
    n_layers=3, d_model=64, vocab=512, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, dense_d_ff=128, first_dense_layers=1,
    n_experts=8, top_k=2, moe_d_ff=64,
)
