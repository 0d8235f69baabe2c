"""deepseek-v3-671b — MoE with MLA attention and MTP.

[arXiv:2412.19437; hf]  61L d_model=7168 128H d_ff(expert)=2048
vocab=129280; MoE: 1 shared + 256 routed experts, top-8; first 3 layers
dense (d_ff 18432, from the public config); MLA: q_lora 1536,
kv_lora 512, qk = 128 nope + 64 rope, v 128; multi-token prediction
(1 MTP depth).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, vocab=129280,
    attn_type="mla", n_heads=128,
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    d_ff=18432, dense_d_ff=18432, first_dense_layers=3,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    mtp=True,
    tie_embeddings=False,
)

TINY = CONFIG.replace(
    n_layers=4, d_model=64, vocab=512, n_heads=4,
    q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, d_ff=128, dense_d_ff=128, first_dense_layers=1,
    n_experts=8, top_k=2, moe_d_ff=64,
)
