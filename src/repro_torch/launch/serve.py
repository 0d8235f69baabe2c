"""Serving driver: batched prefill + decode with a restartable decode loop.

The CRAFT angle on serving: a long decode is exactly the kind of
hours-long, loses-everything-on-failure loop the paper targets.  The
KV/SSM cache, the position counter and the generated tokens are all
CRAFT-checkpointable, so ``serve`` periodically checkpoints the decode
state and a restarted run resumes mid-generation instead of re-prefilling.
The port of ``repro/launch/serve.py``: the same prompts, the same decode
state under the same checkpoint names and files, so a decode checkpoint
written by either package resumes in the other.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --batch 4 --prompt-len 32 --gen 64 --cp-freq 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Box, Checkpoint
from repro_torch.models import model as M
from repro_torch.train.steps import make_decode_step, make_prefill


@dataclasses.dataclass
class ServeConfig:
    arch: str = "h2o-danube-1.8b"
    tiny: bool = True
    batch: int = 4
    prompt_len: int = 32
    gen_tokens: int = 64
    cp_freq: int = 0            # 0 = no decode checkpointing
    cp_name: str = "serve"
    seed: int = 0
    temperature: float = 0.0    # 0 = greedy
    device: str = "cuda"


def prefix_len(cfg) -> int:
    """Positions the modality frontend's stub takes before the prompt."""
    return cfg.n_patches if cfg.frontend else 0


def stub_embeds(cfg, batch: int, seed: int,
                device) -> Optional[torch.Tensor]:
    """The modality frontend's stub, as the reference's ``serve`` builds it:
    ``(batch, n_patches, d_model)`` standard normals from
    ``np.random.default_rng(seed + 1)``, in ``cfg.dtype`` on ``device``;
    None for a model without a frontend."""
    if not cfg.frontend:
        return None
    stub = np.random.default_rng(seed + 1).standard_normal(
        (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(stub).to(device=device, dtype=cfg.dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(sc: ServeConfig, comm=None, env=None, params=None,
        fail_at_token: Optional[int] = None) -> Dict:
    """Prefill a synthetic prompt batch, decode ``gen_tokens`` tokens.

    Returns {"tokens": (B, gen) np.ndarray, "prefill_s", "decode_s",
    "resumed_at": int} as the reference does, plus "restore_s" (seconds of
    ``restart_if_needed``), "cp_writes" ([(token, seconds)] of each decode
    checkpoint written), "logits_finite" (every logit of the run was
    finite) and "last_logits" (the final step's (B, V) logits, float32
    numpy).  ``fail_at_token`` raises after that many generated tokens.

    A model with a modality frontend (``cfg.frontend``) prefills the
    reference's stub (:func:`stub_embeds`) before the prompt, so its
    decode positions start at ``prompt_len + n_patches``; a resumed run
    rebuilds the same stub, since the prefill runs before the restore.

    Greedy decoding (``temperature == 0``) matches the reference.  With
    ``temperature > 0`` each token is drawn by ``torch.multinomial`` from a
    ``torch.Generator`` seeded from ``seed`` and the token index: it is
    reproducible, but cannot reproduce ``jax.random``'s bits.

    On a CUDA device float32 matmuls and convolutions run in full float32
    (``allow_tf32`` off for both), as the reference computes.
    """
    cfg = get_config(sc.arch, tiny=sc.tiny)
    device = torch.device(sc.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if params is None:
        gen = torch.Generator(device=device).manual_seed(sc.seed)
        params = M.init_params(gen, cfg, device)
    prefix = prefix_len(cfg)
    max_len = sc.prompt_len + sc.gen_tokens + prefix
    rng = np.random.default_rng(sc.seed)
    prompts = rng.integers(0, cfg.vocab, (sc.batch, sc.prompt_len),
                           dtype=np.int32)
    embeds = stub_embeds(cfg, sc.batch, sc.seed, device)

    prefill = make_prefill(cfg, sc.batch, max_len, device)
    decode = make_decode_step(cfg)

    t0 = time.perf_counter()
    cache, logits = prefill(params, torch.from_numpy(prompts).to(device),
                            embeds)
    pos0 = sc.prompt_len + prefix
    _sync(device)
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()

    cache_box = Box(cache)
    tok_box = Box(np.zeros((sc.batch, sc.gen_tokens), np.int32))
    i_box = Box(0)

    cp = None
    resumed_at = 0
    restore_s = 0.0
    if sc.cp_freq:
        cp = Checkpoint(sc.cp_name, comm, env=env, device=device)
        cp.add("cache", cache_box)
        cp.add("generated", tok_box)
        cp.add("i", i_box)
        cp.commit()
        t0 = time.perf_counter()
        if cp.restart_if_needed():
            resumed_at = i_box.value
        _sync(device)
        restore_s = time.perf_counter() - t0

    def sample(lg: torch.Tensor, i: int) -> torch.Tensor:
        if sc.temperature <= 0.0:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        g = torch.Generator(device=lg.device).manual_seed(
            sc.seed * 1_000_003 + i)
        probs = torch.softmax(lg.float() / sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=g)[:, 0].to(torch.int32)

    if resumed_at > 0:
        next_tok = torch.from_numpy(
            tok_box.value[:, resumed_at - 1].copy()).to(device)
    else:
        next_tok = sample(logits, 0)

    cp_writes = []
    t0 = time.perf_counter()
    i = i_box.value
    while i < sc.gen_tokens:
        cache_box.value, logits = decode(
            params, cache_box.value, next_tok[:, None], pos0 + i)
        finite &= torch.isfinite(logits).all()
        next_tok = sample(logits, i + 1)
        tok_box.value[:, i] = next_tok.cpu().numpy()
        i += 1
        i_box.value = i
        if cp is not None:
            version, tw = cp.version, time.perf_counter()
            cp.update_and_write(i, sc.cp_freq)
            if cp.version != version:
                cp_writes.append((i, time.perf_counter() - tw))
        if fail_at_token is not None and i == fail_at_token:
            if cp is not None:
                cp.wait()
                cp.close()
            raise RuntimeError(f"injected failure at token {i}")
    _sync(device)
    decode_s = time.perf_counter() - t0
    if cp is not None:
        cp.wait()
        cp.close()
    return {"tokens": tok_box.value, "prefill_s": prefill_s,
            "decode_s": decode_s, "resumed_at": resumed_at,
            "restore_s": restore_s, "cp_writes": cp_writes,
            "logits_finite": bool(finite),
            "last_logits": logits.float().cpu().numpy()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--cp-freq", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics + /healthz on this port (k8s "
                         "liveness probe; same as CRAFT_METRICS_PORT)")
    args = ap.parse_args()
    if args.metrics_port is not None:
        # Start the exporter up front so the replica answers its liveness
        # probe during prefill, before any Checkpoint commits.
        from repro_torch.core import metrics, telemetry

        metrics.install()
        port = telemetry.start(args.metrics_port)
        print(f"telemetry: /metrics + /healthz on port {port}")
    sc = ServeConfig(arch=args.arch, tiny=args.tiny, batch=args.batch,
                     prompt_len=args.prompt_len, gen_tokens=args.gen,
                     cp_freq=args.cp_freq, device=args.device)
    out = run(sc)
    print(f"prefill {out['prefill_s']:.2f}s, decode {out['decode_s']:.2f}s "
          f"({sc.gen_tokens} tokens), resumed_at={out['resumed_at']}")
    print("first sequence:", out["tokens"][0][:16], "...")


if __name__ == "__main__":
    main()
