"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=1536 24H (kv=24 = MHA) d_ff=6144
vocab=2048.  The EnCodec frontend + codebook-interleaving is a STUB per
the assignment: ``input_specs()`` supplies precomputed frame embeddings
added to the token embeddings; the backbone is the deliverable.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, vocab=2048,
    attn_type="gqa", n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144,
    frontend="audio", n_patches=64,   # conditioning-frame prefix (stub)
    tie_embeddings=False,
)

TINY = CONFIG.replace(
    n_layers=3, d_model=64, vocab=128, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128,
)
