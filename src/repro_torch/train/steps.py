"""Step builders: training (grad-accum, clip, MoE aux, MTP) and serving —
the reference's ``repro/train/steps.py``.

``make_train_step(cfg, opt_cfg)`` returns

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

with the reference's metrics (``loss``, ``aux``, ``grad_norm``, ``lr``).
PyTorch runs eagerly, so the step is a plain closure (the reference jits
it), and it updates ``params`` and ``opt_state`` in place (the reference
donates them).  Gradients are taken with ``torch.autograd.grad`` with
respect to detached aliases of the parameters, so the caller's tensors
never require a gradient.  The loss never holds a (B, L, V) logits tensor:
``chunked_cross_entropy`` runs each chunk under
``torch.utils.checkpoint``, as the reference runs it under
``jax.checkpoint``.  Microbatch accumulation (``microbatches > 1``) sums
each microbatch's gradients in float32 (or ``grad_dtype``), then divides
by the count.  The loss adds ``moe_aux_weight`` times the MoE aux loss
and, where the model has an MTP head, ``mtp_weight`` times its cross
entropy, as the reference does.  The forward runs under the trace span
``craft::forward`` (the backward's own spans are in the kernels' ops and
the optimizer's in ``optim.adamw``).

Serving: ``make_prefill`` builds the KV/SSM caches from the prompt in one
shot; ``make_decode_step`` advances one token.  They run under
``torch.no_grad``, not inference mode: a checkpoint restore writes into
the cache outside them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.utils._pytree as pytree
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import embed_apply
from repro_torch.optim.adamw import OptimConfig, adamw_update

IGNORE = -100


class StepTimer:
    """Host-side wall-clock EWMA of the train-step duration.

    Feeds the checkpoint scheduler's rework model: drivers report the
    measured step time via ``policy.observe_step_seconds(timer.last)``.
    """

    def __init__(self, alpha: float = 0.2, clock=time.perf_counter):
        self._alpha = alpha
        self._clock = clock
        self._last_t: Optional[float] = None
        self.last: Optional[float] = None     # most recent step, seconds
        self.ewma: Optional[float] = None     # smoothed step seconds

    def tick(self) -> Optional[float]:
        """Mark a step boundary; returns the seconds since the previous tick
        (None on the first call)."""
        now = self._clock()
        if self._last_t is None:
            self._last_t = now
            return None
        dt = now - self._last_t
        self._last_t = now
        self.observe(dt)
        return dt

    def observe(self, seconds: float) -> None:
        """Feed an explicitly measured step duration."""
        if seconds <= 0:
            return
        self.last = seconds
        self.ewma = seconds if self.ewma is None else (
            (1.0 - self._alpha) * self.ewma + self._alpha * seconds)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    moe_aux_weight: float = 0.01
    mtp_weight: float = 0.3
    grad_dtype: Optional[str] = None     # e.g. "bfloat16"
    loss_chunk: int = 128                # seq positions per CE chunk


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked mean CE; label == IGNORE positions are excluded."""
    nll, n = _ce_sums(logits, labels)
    return nll / torch.clamp(n, min=1.0)


def _ce_sums(logits, labels):
    """(sum of NLL over non-IGNORE positions, count of those positions)."""
    labels = labels.long()
    mask = (labels != IGNORE).to(torch.float32)
    safe = torch.where(labels == IGNORE, 0, labels)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -torch.sum(ll * mask), torch.sum(mask)


def chunked_cross_entropy(hidden, labels, unembed_fn, chunk: int):
    """Masked mean CE without materializing (B, L, V) logits: each chunk of
    ``chunk`` positions unembeds, reduces and is dropped; under autograd
    each chunk runs in ``torch.utils.checkpoint``, so the backward
    recomputes its logits instead of keeping them."""
    b, l, _ = hidden.shape
    chunk = max(1, min(chunk, l))
    pad = (-l) % chunk
    if pad:
        hidden = torch.cat([hidden, hidden.new_zeros(
            (b, pad, hidden.shape[2]))], dim=1)
        labels = torch.cat([labels, torch.full(
            (b, pad), IGNORE, dtype=labels.dtype, device=labels.device)],
            dim=1)

    def body(h, y):
        return _ce_sums(unembed_fn(h), y)

    record = torch.is_grad_enabled() and hidden.requires_grad
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for t0 in range(0, l + pad, chunk):
        h, y = hidden[:, t0:t0 + chunk], labels[:, t0:t0 + chunk]
        c_nll, c_n = (checkpoint(body, h, y, use_reentrant=False)
                      if record else body(h, y))
        nll = nll + c_nll
        n = n + c_n
    return nll / torch.clamp(n, min=1.0)


def _loss_fn(params, cfg: ModelConfig, scfg: TrainStepConfig, batch):
    """(total loss, {"loss", "aux"}) of one batch."""
    tokens = batch["tokens"]
    labels = batch["labels"]
    embeds = batch.get("embeds")
    if cfg.mtp and embeds is not None:
        # the reference builds the MTP input P + L long and the next-token
        # embeddings L long, and cannot concatenate them: no config has both
        raise ValueError(f"{cfg.arch_id}: the MTP head takes no embeds "
                         "prefix")
    hidden, _, aux = M.forward_hidden(params, cfg, tokens=tokens,
                                      embeds=embeds)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=hidden.device)
    if embeds is not None:
        # the modality-stub positions carry no next-token loss
        labels = torch.cat([torch.full(
            embeds.shape[:2], IGNORE, dtype=labels.dtype,
            device=labels.device), labels], dim=1)

    def unembed_fn(h):
        return M.unembed(params, cfg, h)

    loss = chunked_cross_entropy(hidden, labels, unembed_fn, scfg.loss_chunk)
    total = loss + scfg.moe_aux_weight * aux
    if cfg.mtp:
        # predict token t+2 from (embed_t, embed(token_{t+1})): one MTP
        # depth over the token embeddings in place of the backbone's final
        # hidden, as the reference's (``_embed_hidden`` there)
        b, l = tokens.shape
        positions = torch.arange(l, device=hidden.device)
        next_tokens = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        mtp_h = M.mtp_hidden(params, cfg,
                             embed_apply(params["embed"], tokens),
                             next_tokens, positions)
        mtp_labels = torch.cat([labels[:, 1:], torch.full(
            (b, 1), IGNORE, dtype=labels.dtype, device=labels.device)],
            dim=1)
        total = total + scfg.mtp_weight * chunked_cross_entropy(
            mtp_h, mtp_labels, unembed_fn, scfg.loss_chunk)
    return total, {"loss": loss, "aux": aux}


def make_train_step(cfg: ModelConfig, opt_cfg: OptimConfig,
                    scfg: Optional[TrainStepConfig] = None):
    scfg = scfg or TrainStepConfig()
    gdtype = getattr(torch, scfg.grad_dtype) if scfg.grad_dtype else None

    def single_grads(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        alias = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            with record_function("craft::forward"):
                total, parts = _loss_fn(pytree.tree_unflatten(alias, spec),
                                        cfg, scfg, batch)
            grads = torch.autograd.grad(total, alias, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if gdtype is not None:
            grads = [g.to(gdtype) for g in grads]
        parts = {k: v.detach() for k, v in parts.items()}
        return total.detach(), parts, pytree.tree_unflatten(grads, spec)

    def train_step(params, opt_state, batch):
        device = pytree.tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if scfg.microbatches <= 1:
            loss, parts, grads = single_grads(params, batch)
        else:
            mb = scfg.microbatches
            b = batch["tokens"].shape[0]
            if b % mb:
                raise ValueError(f"batch {b} not divisible into {mb} "
                                 "microbatches")
            size = b // mb
            grads = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=gdtype or torch.float32,
                                      device=p.device), params)
            acc = pytree.tree_leaves(grads)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(mb):
                mbatch = {k: v[i * size:(i + 1) * size]
                          for k, v in batch.items()}
                l, parts, g = single_grads(params, mbatch)
                for a, gi in zip(acc, pytree.tree_leaves(g)):
                    a.add_(gi)
                del g
                loss = loss + l
            for a in acc:
                a.div_(mb)
            loss = loss / mb
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        metrics = {"loss": loss, **parts, **om}
        return params, opt_state, metrics

    return train_step


# ==========================================================================
# serving
# ==========================================================================
def make_prefill(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """prefill(params, tokens, [embeds]) -> (cache, last_logits).

    ``max_len`` is the cache's length: it counts an ``embeds`` prefix's P
    positions beside the prompt and the generated tokens.  Only the final
    position is unembedded — the (B, L, V) prompt logits
    tensor is never materialized.
    """

    @torch.no_grad()
    def prefill(params, tokens, embeds=None):
        cache = M.init_cache(cfg, batch, max_len, device=device)
        hidden, cache, _ = M.forward_hidden(
            params, cfg, tokens=tokens, embeds=embeds, cache=cache, pos0=0)
        logits = M.unembed(params, cfg, hidden[:, -1:])
        return cache, logits[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, cache, tokens (B,1), pos int) -> (cache, logits).
    The cache is updated in place (the reference donates it)."""

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        logits, cache, _ = M.forward(
            params, cfg, tokens=tokens, cache=cache, pos0=int(pos))
        return cache, logits[:, -1]

    return decode
