"""falcon-mamba-7b — pure Mamba1 (attention-free) LM.

[arXiv:2410.05355; unverified]  64L d_model=4096 vocab=65024
ssm_state=16; mamba1 arch: expand 2 → d_inner 8192, conv 4,
dt_rank = ceil(4096/16) = 256.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, vocab=65024,
    attn_type="none", d_ff=0,
    ssm_type="mamba1", ssm_state=16, ssm_expand=2, ssm_conv=4,
    tie_embeddings=False,
)

TINY = CONFIG.replace(
    n_layers=3, d_model=64, vocab=256, ssm_state=8, ssm_chunk=16,
    dt_rank=8,
)
