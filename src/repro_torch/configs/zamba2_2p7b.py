"""zamba2-2.7b — hybrid Mamba2 + weight-shared attention blocks.

[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000 ssm_state=64.  Mamba2 backbone (expand 2 → d_inner 5120,
head_dim 64 → 80 SSD heads); one weight-SHARED transformer block applied
after every 6 mamba blocks (9 applications).  Deviation from the released
model (noted in DESIGN.md): the shared block consumes d_model, not the
concat(hidden, embedding) variant, and per-application LoRA deltas are
omitted.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, vocab=32000,
    attn_type="gqa", n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240,
    ssm_type="mamba2", ssm_state=64, ssm_expand=2, ssm_conv=4,
    ssm_head_dim=64, ssm_groups=1,
    shared_attn_every=6,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    n_layers=6, d_model=64, vocab=512, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, ssm_state=16, ssm_head_dim=16,
    shared_attn_every=3, ssm_chunk=16,
)
