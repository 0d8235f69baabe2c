"""llava-next-34b — VLM: yi-34b backbone + anyres vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  Backbone: 60L
d_model=7168 56H (kv=8) d_ff=20480 vocab=64000.  The anyres tiling /
CLIP tower is a STUB per the assignment: ``input_specs()`` supplies
``n_patches`` precomputed patch embeddings prepended to the text tokens.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, vocab=64000,
    attn_type="gqa", n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, rope_theta=5e6,
    frontend="vision", n_patches=1152,
    tie_embeddings=False,
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, vocab=512, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, n_patches=8,
)
