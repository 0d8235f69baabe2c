"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]  24L d_model=2560 32H (kv=8) d_ff=6912
vocab=32000, SWA window 4096 → the KV cache is bounded by the window,
which is what makes the ``long_500k`` decode shape runnable.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, vocab=32000,
    attn_type="gqa", n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, window=4096,
    tie_embeddings=False,
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, vocab=512, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, window=32,
)
