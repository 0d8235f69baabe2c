"""A plain reference of the released Zamba2 language model, in float32.

Follows Zyphra's published description of Zamba2 (the Zamba2-7B
``config.json`` and the layer equations of its public modelling code):
token embeddings; 81 (``num_hidden_layers``) Mamba2 layers
``x + mamba(norm(x))``; before each layer of ``hybrid_layer_ids``, one
application of the ``num_mem_blocks`` shared transformer blocks, taken in
turn, on ``concat(x, embeddings)``: RMSNorm, causal attention with RoPE
(``rotate_half``, theta ``rope_theta``) and scale ``1/sqrt(kv_channels)``,
RMSNorm, the gated ``hidden_act`` MLP whose gate/up projection adds the
application's own LoRA adapter, and the application's own linear; its
output t enters the layer as ``x + mamba(norm(x + t))``; the final RMSNorm
and the head.  The Mamba2 mixer: in_proj to (gate z, x B C, dt), the
depthwise causal conv with bias and SiLU, dt = softplus(dt + dt_bias), the
SSD recurrence h_t = exp(dt A) h_{t-1} + dt B_t x_t, y = C_t h_t + D x,
then RMSNorm of y * silu(z) over each of the ``mamba_ngroups`` groups.

Weights are a dict named as the released checkpoints name them
(``Zamba2ForCausalLM.state_dict()``), in any dtype: each is taken in
float32 where it is used, so gradients reach float32 leaves that require
them.  Hyperparameters are the published ``config.json`` keys.  Plain
torch operations only: no kernel, no cache, no batching tricks; the SSD
scan is the plain chunked form (``chunk_size`` steps a chunk, the carry
between chunks one chunk at a time); attention is computed a block of
heads at a time.  TF32 is turned off on entry.

Departures from the published description, each deliberate:
  * dt is not clamped below at ``time_step_min``: with ``time_step_limit``
    null the released kernels bound dt to (0, inf); only the plain path of
    the modelling code clamps;
  * no attention mask other than the causal one (no padding), no dropout;
  * everything in float32 (the released weights are bfloat16).

This file imports torch alone; ``bench/reference/zamba2.py`` is a copy.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

IGNORE = -100
HEAD_BLOCK = 8          # attention heads computed at once


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _w(sd: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return sd[name].float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _act(name: str):
    return {"gelu": lambda x: F.gelu(x), "silu": F.silu,
            "swish": F.silu}[name]


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def attention(x: torch.Tensor, sd, pre: str, hp: dict) -> torch.Tensor:
    """Causal self-attention of x (B, L, attention_hidden_size) → (B, L,
    hidden_size)."""
    b, l, _ = x.shape
    h, hd = int(hp["num_attention_heads"]), int(hp["attention_head_dim"])
    hkv = int(hp.get("num_key_value_heads") or h)
    scale = float(hp["kv_channels"]) ** -0.5
    q = (x @ _w(sd, pre + "q_proj.weight").t()).view(b, l, h, hd)
    k = (x @ _w(sd, pre + "k_proj.weight").t()).view(b, l, hkv, hd)
    v = (x @ _w(sd, pre + "v_proj.weight").t()).view(b, l, hkv, hd)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (B, H, L, hd)
    inv = 1.0 / (float(hp["rope_theta"]) ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    freqs = torch.arange(l, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos(), emb.sin()
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    outs = []
    for h0 in range(0, h, HEAD_BLOCK):
        s = (q[:, h0:h0 + HEAD_BLOCK] @ k[:, h0:h0 + HEAD_BLOCK]
             .transpose(-1, -2)) * scale
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(p @ v[:, h0:h0 + HEAD_BLOCK])
    o = torch.cat(outs, dim=1).transpose(1, 2).reshape(b, l, h * hd)
    return o @ _w(sd, pre + "o_proj.weight").t()


def ssd(x, dt, a, bmat, cmat, chunk: int) -> torch.Tensor:
    """The SSD recurrence from h = 0 in its chunked form.  x (B, L, H, P),
    dt (B, L, H), a (H,), bmat and cmat (B, L, H, N) → y (B, L, H, P)."""
    b, l, h, p = x.shape
    pad = (-l) % chunk
    if pad:
        x, dt, bmat, cmat = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                             for t in (x, dt, bmat, cmat))
    c = x.shape[1] // chunk
    x, dt, bmat, cmat = (t.reshape(b, c, chunk, *t.shape[2:])
                         for t in (x, dt, bmat, cmat))
    da = dt * a                                          # (B, C, Q, H)
    cum = torch.cumsum(da, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, C, i, j, H)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    g = torch.einsum("bcihn,bcjhn->bcijh", cmat, bmat)
    xdt = x * dt[..., None]
    y = torch.einsum("bcijh,bcjhp->bcihp", g * decay, xdt)
    # each chunk's end state from 0, then carried across the chunks
    to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B, C, Q, H)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", bmat, to_end, xdt)
    state = torch.zeros_like(states[:, 0])
    carried = []
    for i in range(c):
        carried.append(state)
        state = torch.exp(cum[:, i, -1, :])[:, :, None, None] * state \
            + states[:, i]
    h_in = torch.stack(carried, dim=1)                   # (B, C, H, P, N)
    y = y + torch.einsum("bcihn,bchpn,bcih->bcihp", cmat, h_in,
                         torch.exp(cum))
    return y.reshape(b, c * chunk, h, p)[:, :l]


def mamba(x: torch.Tensor, sd, pre: str, hp: dict) -> torch.Tensor:
    """The Mamba2 mixer of x (B, L, hidden_size)."""
    b, l, d = x.shape
    di = int(hp["mamba_expand"]) * d
    n, g = int(hp["mamba_d_state"]), int(hp["mamba_ngroups"])
    p = int(hp["mamba_headdim"])
    nh = di // p
    k = int(hp["mamba_d_conv"])
    proj = x @ _w(sd, pre + "in_proj.weight").t()
    z, xbc, dt = torch.split(proj, [di, di + 2 * g * n, nh], dim=-1)
    conv_w = _w(sd, pre + "conv1d.weight")                 # (C, 1, K)
    xbc = F.conv1d(xbc.transpose(1, 2), conv_w, _w(sd, pre + "conv1d.bias"),
                   padding=k - 1, groups=conv_w.shape[0])[..., :l]
    xbc = F.silu(xbc.transpose(1, 2))
    xs, bmat, cmat = torch.split(xbc, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b, l, nh, p)
    bmat = bmat.reshape(b, l, g, n).repeat_interleave(nh // g, dim=2)
    cmat = cmat.reshape(b, l, g, n).repeat_interleave(nh // g, dim=2)
    dt = F.softplus(dt + _w(sd, pre + "dt_bias"))
    a = -torch.exp(_w(sd, pre + "A_log"))
    y = ssd(xs, dt, a, bmat, cmat, int(hp["chunk_size"]))
    y = (y + _w(sd, pre + "D")[:, None] * xs).reshape(b, l, di)
    gated = (y * F.silu(z)).reshape(b, l, g, di // g)
    gated = gated * torch.rsqrt(gated.square().mean(-1, keepdim=True)
                                + float(hp["rms_norm_eps"]))
    y = gated.reshape(b, l, di) * _w(sd, pre + "norm.weight")
    return y @ _w(sd, pre + "out_proj.weight").t()


def shared_block(x, emb, sd, pre: str, app: int, hp: dict) -> torch.Tensor:
    """One application (number ``app``) of the shared block under ``pre``
    (``model.layers.<i>.shared_transformer.``); no residual inside."""
    eps = float(hp["rms_norm_eps"])
    h = rms_norm(torch.cat([x, emb], dim=-1),
                 _w(sd, pre + "input_layernorm.weight"), eps)
    h = attention(h, sd, pre + "self_attn.", hp)
    h = rms_norm(h, _w(sd, pre + "pre_ff_layernorm.weight"), eps)
    ff = pre + "feed_forward."
    gu = h @ _w(sd, ff + "gate_up_proj.weight").t()
    if hp.get("use_shared_mlp_adapter", True):
        ad = f"{ff}gate_up_proj_adapter_list.{app}."
        gu = gu + (h @ _w(sd, ad + "0.weight").t()) \
            @ _w(sd, ad + "1.weight").t()
    gate, up = gu.chunk(2, dim=-1)
    return (_act(hp["hidden_act"])(gate) * up) \
        @ _w(sd, ff + "down_proj.weight").t()


def hidden(sd, hp: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The final normed hidden states (B, L, hidden_size) of ``tokens``."""
    _no_tf32()
    eps = float(hp["rms_norm_eps"])
    emb = _w(sd, "model.embed_tokens.weight")[tokens.long()]
    x = emb
    apps = {int(i): a for a, i in enumerate(hp["hybrid_layer_ids"])}
    for i in range(int(hp["num_hidden_layers"])):
        pre = f"model.layers.{i}."
        if i in apps:
            t = shared_block(x, emb, sd, pre + "shared_transformer.",
                             apps[i], hp)
            t = t @ _w(sd, pre + "linear.weight").t()
            pre = pre + "mamba_decoder."
            h = x + t
        else:
            h = x
        h = rms_norm(h, _w(sd, pre + "input_layernorm.weight"), eps)
        x = x + mamba(h, sd, pre + "mamba.", hp)
    return rms_norm(x, _w(sd, "model.final_layernorm.weight"), eps)


def logits(sd, hp: dict, tokens: torch.Tensor,
           positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (B, L, V), or (B, P, V) at ``positions`` (P,) alone."""
    x = hidden(sd, hp, tokens)
    if positions is not None:
        x = x[:, positions]
    return x @ _w(sd, "lm_head.weight").t()


def loss(sd, hp: dict, tokens: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of the next-token ``labels`` over the positions
    whose label is not -100."""
    return cross_entropy(logits(sd, hp, tokens), labels)


def cross_entropy(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of logits ``lg`` (B, L, V) over the positions
    whose label is not -100."""
    labels = labels.long()
    keep = labels != IGNORE
    nll = -torch.log_softmax(lg, dim=-1).gather(
        -1, torch.where(keep, labels, 0)[..., None])[..., 0]
    return (nll * keep).sum() / keep.sum().clamp(min=1)


def n_params(hp: dict) -> int:
    """The parameters of the model ``hp`` describes, tied head, from the
    widths (each shared block and each application's weights once)."""
    d, v = int(hp["hidden_size"]), int(hp["vocab_size"])
    di = int(hp["mamba_expand"]) * d
    n, g = int(hp["mamba_d_state"]), int(hp["mamba_ngroups"])
    nh, k = di // int(hp["mamba_headdim"]), int(hp["mamba_d_conv"])
    f, r = int(hp["intermediate_size"]), int(hp["adapter_rank"])
    h, hd = int(hp["num_attention_heads"]), int(hp["attention_head_dim"])
    hkv = int(hp.get("num_key_value_heads") or h)
    a = 2 * d
    conv = di + 2 * g * n
    layer = d + d * (2 * di + 2 * g * n + nh) + conv * (k + 1) + 3 * nh \
        + di + di * d
    block = a + a * (h + 2 * hkv) * hd + h * hd * d + d + 3 * d * f
    app = d * d + (r * (d + 2 * f)
                   if hp.get("use_shared_mlp_adapter", True) else 0)
    return (v * d + d + int(hp["num_hidden_layers"]) * layer
            + int(hp["num_mem_blocks"]) * block
            + len(hp["hybrid_layer_ids"]) * app)

