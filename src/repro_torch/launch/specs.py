"""Input and state stand-ins for the dry-run (the reference's
``repro/launch/specs.py``).

``input_specs(cfg, shape, rules, mesh)`` and the ``build_*`` step builders
return *sharded* stand-ins for every model input: DTensors whose local
shards are ``FakeTensorMode`` tensors, so no memory is ever allocated and
the full-size configs are exercised on the fake process group of
``launch.dryrun``.  The host scalars the port keeps on the CPU (the
optimizer's ``count``, the caches' ``pos``) are real host tensors.

Three step kinds map to the shape kinds:

    train_4k      → ``train_step(params, opt_state, batch)``
    prefill_32k   → ``prefill(params, tokens[, embeds])``
    decode_32k /
    long_500k     → ``decode(params, cache, tokens (B,1), pos)``

Audio/VLM archs get a modality-stub ``embeds`` prefix of ``cfg.n_patches``
frames/patches; the token span shrinks so the total sequence stays at the
shape's ``seq_len``.

The reference lowers and compiles its step; the port has no compile:
:meth:`BuiltStep.lower` traces the step once, eagerly, on the stand-ins,
under the rules and the roofline's counter (``analysis.roofline``), and
returns what the dry-run reports: the counter and the per-device bytes of
the step's arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils._pytree as pytree

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import OptimConfig, adamw_init, opt_state_logical
from repro_torch.sharding.activations import mesh_context
from repro_torch.sharding.logical import (
    LogicalRules, dtensor_of, mesh_sizes, placements, shard_specs,
)
from repro_torch.train.steps import (
    TrainStepConfig, make_decode_step, make_prefill, make_train_step,
)

# the fake shards' device: a trace needs no card.  A fake tensor takes the
# card's route where the two differ (the scan's y in the input's dtype and
# its chunk states every ``kernel.CHUNK`` steps: ``kernels.ssm_scan.ops``)
DEVICE = "cpu"


def fake_mode():
    """The fake-tensor mode the stand-ins live in.  Real host tensors (the
    positions, a zero initial state, the host scalars) may join them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def stand_in(shape, dtype, spec, mesh, mode):
    """A DTensor of global ``shape`` placed by ``spec`` whose local shard
    is a fake tensor (no memory)."""
    def make(local):
        with mode:
            return torch.empty(local, dtype=dtype, device=DEVICE)

    return dtensor_of(shape, mesh, placements(spec, mesh), make)


def _stand_ins(shapes, specs, mesh, mode, host_value: int = 0):
    """Stand-ins for a tree of shapes and specs: a meta leaf becomes a
    sharded fake stand-in, a host leaf (the port's host scalars, on the
    CPU) a real host tensor holding ``host_value``."""
    return pytree.tree_map(
        lambda s, sp: (torch.full(s.shape, host_value, dtype=s.dtype)
                       if not s.is_meta
                       else stand_in(s.shape, s.dtype, sp, mesh, mode)),
        shapes, specs, is_leaf=lambda x: isinstance(x, torch.Tensor))


def local_bytes(tree) -> int:
    """Bytes a device holds of a tree: each DTensor's local shard, each
    plain tensor whole."""
    from torch.distributed.tensor import DTensor

    total = 0
    for x in pytree.tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def arch_config(arch_id: str, mesh, tiny: bool = False) -> ModelConfig:
    """Arch config adjusted for the mesh's tensor-parallel degree."""
    cfg = get_config(arch_id, tiny=tiny)
    return cfg.padded_for_tp(mesh_sizes(mesh).get("model", 1))


def dryrun_opt(cfg: ModelConfig) -> OptimConfig:
    """Per-arch optimizer policy: ≥100B params → 8-bit moments, no master
    copy (the reference's policy)."""
    big = cfg.param_count() > 100e9
    return OptimConfig(state_bits=8 if big else 32, master_fp32=False)


@dataclasses.dataclass
class Lowered:
    """A traced step: the roofline counter of its trace and the bytes each
    device holds of its arguments."""
    counter: object
    arg_bytes: int

    @property
    def peak_per_device_bytes(self) -> int:
        return self.arg_bytes + self.counter.peak_bytes


@dataclasses.dataclass
class BuiltStep:
    """A traced-ready step: ``lower()`` is all that's left."""
    fn: object                  # the step function
    args: tuple                 # sharded stand-ins
    out_shardings: object       # specs of the outputs the step keeps
    donate_argnums: tuple       # arguments updated in place
    cfg: ModelConfig
    rules: object = None        # LogicalRules for activation constraints

    def lower(self, mesh=None) -> Lowered:
        """Trace the step once on the stand-ins, under the rules and the
        roofline's counter."""
        from repro_torch.analysis import roofline

        rules = self.rules if self.rules is not None else LogicalRules(mesh)
        arg_bytes = local_bytes(self.args)
        with mesh_context(rules):
            _, counter = roofline.trace(self.fn, *self.args)
        return Lowered(counter=counter, arg_bytes=arg_bytes)


# ------------------------------------------------------------------ batch
def input_specs(cfg: ModelConfig, shape: ShapeSpec, rules: LogicalRules,
                mesh, mode=None) -> dict:
    """Training/prefill token batch as sharded stand-ins."""
    mode = mode or fake_mode()
    b, l = shape.global_batch, shape.seq_len
    n_stub = cfg.n_patches if cfg.frontend else 0
    l_tok = l - n_stub
    spec = rules.spec("batch", "seq", shape=(b, l_tok))
    out = {
        "tokens": stand_in((b, l_tok), torch.int32, spec, mesh, mode),
        "labels": stand_in((b, l_tok), torch.int32, spec, mesh, mode),
    }
    if n_stub:
        out["embeds"] = stand_in(
            (b, n_stub, cfg.d_model), cfg.dtype,
            rules.spec("batch", "patches", "embed_act",
                       shape=(b, n_stub, cfg.d_model)), mesh, mode)
    return out


def param_specs(cfg: ModelConfig, rules: LogicalRules, mesh, mode=None):
    shapes = M.init_params(None, cfg, "meta")
    specs = shard_specs(rules, M.param_logical(cfg), shapes)
    return _stand_ins(shapes, specs, mesh, mode or fake_mode()), specs


def opt_specs(cfg: ModelConfig, ocfg: OptimConfig, rules: LogicalRules,
              mesh, mode=None):
    pshapes = M.init_params(None, cfg, "meta")
    shapes = adamw_init(pshapes, ocfg)
    logical = opt_state_logical(M.param_logical(cfg), ocfg, params=pshapes)
    specs = shard_specs(rules, logical, shapes)
    return _stand_ins(shapes, specs, mesh, mode or fake_mode()), specs


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                rules: LogicalRules, mesh, mode=None, pos: int = 0):
    """The cache's stand-ins; its host ``pos`` leaves hold ``pos``."""
    shapes = M.init_cache(cfg, batch, max_len, device="meta")
    specs = shard_specs(rules, M.cache_logical(cfg), shapes)
    return _stand_ins(shapes, specs, mesh, mode or fake_mode(), pos), specs


# ------------------------------------------------------------- step builders
def train_rules(mesh, sequence_parallel: bool = True,
                profile: str = "tp2d") -> LogicalRules:
    """Training parallelism profiles (the reference's).

    ``tp2d`` — MaxText-style 2-D: batch over (pod, data), weights FSDP over
    data × TP over model.  With ``sequence_parallel`` the residual stream's
    d_model shards over the model axis (Megatron-SP).

    ``fsdp`` — pure ZeRO-3: batch over (pod, data, **model**) and weights
    sharded over (data, model); layer weights are all-gathered on use.
    MoE archs keep ``tp2d`` (experts need the model axis for EP).
    """
    rules = LogicalRules(mesh)
    if profile == "fsdp":
        rules.rules.update({
            "batch": ("pod", "data", "model"),
            "embed": ("data", "model"),
            "heads": None, "kv_heads": None, "mlp": None, "vocab": "model",
            "ssm_inner": None, "ssm_heads": None, "latent": None,
            "embed_act": None,
        })
        return rules
    if sequence_parallel:
        rules.rules["embed_act"] = "model"
    return rules


def train_profile(cfg: ModelConfig) -> str:
    """Default profile per arch family: MoE keeps 2-D (EP needs the model
    axis); dense/SSM/hybrid train pure-FSDP."""
    return "tp2d" if cfg.n_experts else "fsdp"


def build_train(cfg: ModelConfig, shape: ShapeSpec, mesh,
                ocfg: Optional[OptimConfig] = None,
                scfg: Optional[TrainStepConfig] = None,
                sequence_parallel: bool = True,
                profile: Optional[str] = None) -> BuiltStep:
    rules = train_rules(mesh, sequence_parallel,
                        profile or train_profile(cfg))
    ocfg = ocfg or dryrun_opt(cfg)
    # bf16 gradients and 512-token CE chunks, as the reference's dry-run
    scfg = scfg or TrainStepConfig(grad_dtype="bfloat16", loss_chunk=512)
    mode = fake_mode()
    p_sds, p_specs = param_specs(cfg, rules, mesh, mode)
    o_sds, o_specs = opt_specs(cfg, ocfg, rules, mesh, mode)
    batch = input_specs(cfg, shape, rules, mesh, mode)
    step = make_train_step(cfg, ocfg, scfg)
    return BuiltStep(fn=step, args=(p_sds, o_sds, batch),
                     out_shardings=(p_specs, o_specs, None),
                     donate_argnums=(0, 1), cfg=cfg, rules=rules)


def build_prefill(cfg: ModelConfig, shape: ShapeSpec, mesh) -> BuiltStep:
    rules = LogicalRules(mesh)
    mode = fake_mode()
    p_sds, _ = param_specs(cfg, rules, mesh, mode)
    batch = input_specs(cfg, shape, rules, mesh, mode)
    c_specs = shard_specs(rules, M.cache_logical(cfg),
                          M.init_cache(cfg, shape.global_batch,
                                       shape.seq_len, device="meta"))
    prefill = make_prefill(cfg, shape.global_batch, shape.seq_len,
                           device=DEVICE)

    def fn(params, tokens, embeds=None):
        cache = _fake_cache(cfg, shape.global_batch, shape.seq_len, rules,
                            mesh, mode)
        return prefill(params, tokens, embeds, cache=cache)

    args = (p_sds, batch["tokens"])
    if "embeds" in batch:
        args = args + (batch["embeds"],)
    return BuiltStep(fn=fn, args=args, out_shardings=(c_specs, None),
                     donate_argnums=(), cfg=cfg, rules=rules)


def _fake_cache(cfg, batch, max_len, rules, mesh, mode):
    return cache_specs(cfg, batch, max_len, rules, mesh, mode)[0]


def build_decode(cfg: ModelConfig, shape: ShapeSpec, mesh) -> BuiltStep:
    """One decode step at the cache's last position (``seq_len - 1``)."""
    rules = LogicalRules(mesh)
    mode = fake_mode()
    pos = shape.seq_len - 1
    p_sds, _ = param_specs(cfg, rules, mesh, mode)
    c_sds, c_specs = cache_specs(cfg, shape.global_batch, shape.seq_len,
                                 rules, mesh, mode, pos=pos)
    b = shape.global_batch
    tokens = stand_in((b, 1), torch.int32,
                      rules.spec("batch", None, shape=(b, 1)), mesh, mode)
    fn = make_decode_step(cfg)
    return BuiltStep(fn=fn, args=(p_sds, c_sds, tokens, pos),
                     out_shardings=(c_specs, None), donate_argnums=(1,),
                     cfg=cfg, rules=rules)


def build_step(arch_id: str, shape: ShapeSpec, mesh,
               tiny: bool = False) -> BuiltStep:
    cfg = arch_config(arch_id, mesh, tiny=tiny)
    if shape.kind == "train":
        return build_train(cfg, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh)
    return build_decode(cfg, shape, mesh)

