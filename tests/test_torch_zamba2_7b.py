"""The released Zamba2 block (``zamba2-7b``) in the port, on the CPU.

TINY (10 layers, hybrid ids [2, 4, 6, 8], so each of the two shared blocks
is applied twice; 2 B/C groups; adapter rank 8) in float32 on seeded
weights, the port (its kernels' plain versions forward, the same backward
code the card runs) against the plain reference ``models/zamba2_ref.py``
given the same weights under the released checkpoint's names
(``configs.zamba2_7b.hf_state_dict``): logits, loss and every gradient,
each shared block's gradient summed over the layers that apply it.  The
tolerance is 1e-5: of the logits' largest magnitude, of the loss, and of
the largest gradient magnitude of each leaf's layer (the same float32 sums
taken in another order).  Then the reference against
``transformers``' Zamba2 modules with the same state dict loaded, the
benchmark's copy of the reference against the repo's, the parameter
count, and a ``launch.train.run`` that resumes bit for bit.
"""
import os
import sys
from pathlib import Path

import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.configs import PORT_ONLY, get_config
from repro_torch.configs import zamba2_7b as Z
from repro_torch.models import model as M
from repro_torch.models import zamba2_ref as R
from repro_torch.train import steps as S

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5

#: TINY's widths as the published config's keys
TINY_HP = dict(
    Z.PUBLISHED, hidden_size=64, vocab_size=512, num_attention_heads=4,
    num_key_value_heads=4, attention_head_dim=32, attention_hidden_size=128,
    kv_channels=16, intermediate_size=128, ffn_hidden_size=128,
    mamba_d_state=16, mamba_headdim=16, n_mamba_heads=8, chunk_size=16,
    hybrid_layer_ids=[2, 4, 6, 8], num_hidden_layers=10, adapter_rank=8)


def _cfg():
    return Z.TINY.replace(param_dtype="float32")


def _params(seed: int = 0):
    """TINY's seeded float32 weights, the mamba scalars and norms moved off
    their constant initial values so each of them matters."""
    cfg = _cfg()
    gen = torch.Generator().manual_seed(seed)
    params = M.init_params(gen, cfg, "cpu")
    for k in ("A_log", "dt_bias", "D", "norm_w", "conv_b"):
        x = params["blocks"]["ssm"][k]
        x.add_(0.1 * torch.randn(x.shape, generator=gen))
    for k in ("ln1", "ln2"):
        x = params["shared_blocks"][k]
        x.add_(0.1 * torch.randn(x.shape, generator=gen))
    return cfg, params, gen


def _batch(gen, b: int = 2, l: int = 40, vocab: int = 512):
    return (torch.randint(0, vocab, (b, l), generator=gen),
            torch.randint(0, vocab, (b, l), generator=gen))


def _close(got, want, what: str, tol: float = TOL) -> None:
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


def test_tiny_reads_the_published_keys():
    assert Z.from_hf_config(TINY_HP).replace(
        param_dtype="float32") == _cfg()
    assert Z.CONFIG.hybrid_layer_ids == tuple(
        Z.PUBLISHED["hybrid_layer_ids"])
    assert (Z.CONFIG.hd, Z.CONFIG.attn_in, Z.CONFIG.ssm_heads) == \
        (224, 7168, 112)
    assert Z.CONFIG.sm_scale == pytest.approx(112 ** -0.5)
    assert "zamba2-7b" in PORT_ONLY and get_config("zamba2-7b") is Z.CONFIG


@pytest.mark.parametrize("hp,cfg", [
    (Z.PUBLISHED, Z.CONFIG), (TINY_HP, Z.TINY),
    (dict(Z.PUBLISHED, num_hidden_layers=12, hybrid_layer_ids=[6, 11]),
     Z.CONFIG.replace(n_layers=12, hybrid_layer_ids=(6, 11)))],
    ids=["published", "tiny", "d12"])
def test_param_count_counts_every_leaf(hp, cfg):
    """Both blocks, the adapters and the linears: the count equals the
    tree's leaves and the reference's count from the widths."""
    n = sum(x.numel() for x in pytree.tree_leaves(
        M.init_params(None, cfg, "meta")))
    assert cfg.param_count() == n == R.n_params(hp)


def test_d12_counts_as_reckoned():
    cfg = Z.CONFIG.replace(n_layers=12, hybrid_layer_ids=(6, 11))
    mamba, block = 78_437_456, 333_982_208
    adapter, linear, embed = 4_128_768, 12_845_056, 114_688_000
    assert cfg.param_count() == 12 * mamba + 2 * (block + adapter + linear) \
        + embed + 3584 == 1_757_853_120


def test_logits_equal_reference():
    cfg, params, gen = _params()
    tokens, _ = _batch(gen)
    with torch.no_grad():
        got, _, _ = M.forward(params, cfg, tokens=tokens)
        want = R.logits(Z.hf_state_dict(params, cfg), TINY_HP, tokens)
    _close(got, want, "logits")


def _port_loss_and_grads(cfg, params, tokens, labels):
    leaves, spec = pytree.tree_flatten(params)
    alias = [p.detach().requires_grad_() for p in leaves]
    loss, _ = S._loss_fn(pytree.tree_unflatten(alias, spec), cfg,
                         S.TrainStepConfig(loss_chunk=16),
                         {"tokens": tokens, "labels": labels})
    grads = torch.autograd.grad(loss, alias)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def test_loss_and_every_gradient_equal_reference():
    cfg, params, gen = _params(1)
    tokens, labels = _batch(gen)
    loss, grads = _port_loss_and_grads(cfg, params, tokens, labels)
    # the reference's weights as float32 leaves of their own, one per name
    sd = {k: v.detach().clone().requires_grad_()
          for k, v in Z.hf_state_dict(params, cfg).items()}
    ref_loss = R.loss(sd, TINY_HP, tokens, labels)
    names = list(sd)
    ref_grads = dict(zip(names, torch.autograd.grad(
        ref_loss, [sd[k] for k in names], allow_unused=True)))
    assert abs(loss.item() - ref_loss.item()) <= TOL * abs(ref_loss.item())
    # the port's gradients under the same names: a name that appears under
    # several layers (a shared block, its applications' adapters, the tied
    # head) takes the sum of the reference's gradients over all of them
    port = Z.hf_state_dict(grads, cfg)
    # (an adapter is read only under its own application's layer: its
    # copies under the block's other layers take no gradient)
    summed = {}
    for k in names:
        key, g = _leaf_key(k, cfg), ref_grads[k]
        if g is not None:
            summed[key] = g if key not in summed else summed[key] + g
    # each leaf at 1e-5 of the largest gradient magnitude of its layer: a
    # per-head scalar's gradient (A_log, dt_bias, D) is a sum over every
    # position, channel and state whose terms cancel, so its own largest
    # magnitude is no measure of the float32 rounding in it
    scale = {}
    for key, g in summed.items():
        grp = _layer_of(key)
        scale[grp] = max(scale.get(grp, 0.0), g.abs().max().item())
    firsts = {}
    for k in names:
        firsts.setdefault(_leaf_key(k, cfg), k)
    for key, k in firsts.items():
        err = (port[k] - summed[key]).abs().max().item()
        assert err <= TOL * scale[_layer_of(key)], (key, err)
    # each shared block is applied twice at TINY, so summing mattered
    assert any(_leaf_key(k, cfg) != k for k in names)


def _layer_of(key: str) -> str:
    """The layer a leaf's key belongs to: a mamba layer, a shared block, an
    application's adapter, or the leaf itself."""
    parts = key.split(".")
    if key.startswith("model.layers."):
        return ".".join(parts[:3])
    if key.startswith("adapter."):
        return ".".join(parts[:4])
    return parts[0]


def _leaf_key(name: str, cfg) -> str:
    """The name of the port's leaf behind a released-checkpoint name: a
    shared block's weights under the block's number, an adapter under its
    application's, the tied head under the embedding."""
    if name == "lm_head.weight" and cfg.tie_embeddings:
        return "model.embed_tokens.weight"
    if ".shared_transformer." not in name:
        return name
    layer = int(name.split(".")[2])
    app = cfg.hybrid_layer_ids.index(layer)
    rest = name.split(".shared_transformer.", 1)[1]
    if "adapter_list" in rest:
        return "adapter." + rest
    return f"block{app % cfg.n_shared_blocks}.{rest}"


def test_the_faults_the_benchmark_breaks_move_the_logits():
    """Each change the benchmark's faults make to the program changes the
    TINY logits far beyond the tolerance."""
    from repro_torch.models import ssm

    cfg, params, gen = _params(2)
    tokens, _ = _batch(gen)
    no_adapter = {**params, "hybrid": {"linear": params["hybrid"]["linear"]}}
    whole = ssm.gated_norm
    with torch.no_grad():
        want = R.logits(Z.hf_state_dict(params, cfg), TINY_HP, tokens)
        got = [M.forward(no_adapter, cfg.replace(adapter_rank=0),
                         tokens=tokens)[0]]
        ssm.gated_norm = lambda y, z, w, groups, eps: whole(y, z, w, 1, eps)
        try:
            got.append(M.forward(params, cfg, tokens=tokens)[0])
        finally:
            ssm.gated_norm = whole
    for g in got:
        assert (g - want).abs().max() / want.abs().max() > 1e3 * TOL


def test_reference_equals_transformers_zamba2():
    """The reference against ``transformers``' Zamba2 modules with the
    same state dict loaded (their plain path, float32, eager attention).
    The sequence fits one chunk of the SSD scan: their plain path sums the
    states carried between chunks over the wrong axis (``.sum(dim=2)``
    where Mamba2's minimal SSD sums over the source chunk), which is exact
    only within one chunk or where a chunk's decay vanishes; the
    reference's chunking is held to the sequential recurrence below.
    Their plain path also clamps dt below at ``time_step_min`` (the
    reference does not: see its notes), so dt_bias is raised here."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    tf = pytest.importorskip("transformers")
    cfg, params, gen = _params(3)
    # dt = softplus(dt_bias + x W) of about 0.3 rather than 0.02, so that
    # no dt falls below the plain path's floor
    params["blocks"]["ssm"]["dt_bias"].add_(3.0)
    tokens, _ = _batch(gen, l=37)
    hp = dict(TINY_HP, chunk_size=64)
    layers = ["mamba"] * hp["num_hidden_layers"]
    for i in hp["hybrid_layer_ids"]:
        layers[i] = "hybrid"
    hcfg = tf.Zamba2Config(
        vocab_size=hp["vocab_size"], hidden_size=hp["hidden_size"],
        num_hidden_layers=hp["num_hidden_layers"], layers_block_type=layers,
        mamba_d_state=hp["mamba_d_state"], mamba_d_conv=hp["mamba_d_conv"],
        mamba_expand=hp["mamba_expand"], mamba_ngroups=hp["mamba_ngroups"],
        n_mamba_heads=hp["n_mamba_heads"], chunk_size=hp["chunk_size"],
        intermediate_size=hp["intermediate_size"],
        hidden_act=hp["hidden_act"],
        num_attention_heads=hp["num_attention_heads"],
        num_key_value_heads=hp["num_key_value_heads"],
        num_mem_blocks=hp["num_mem_blocks"],
        adapter_rank=hp["adapter_rank"], use_mem_rope=True,
        rope_theta=hp["rope_theta"], rms_norm_eps=hp["rms_norm_eps"],
        use_shared_attention_adapter=False, tie_word_embeddings=True,
        attn_implementation="eager")
    assert (hcfg.attention_head_dim, hcfg.kv_channels,
            hcfg.hybrid_layer_ids) == (hp["attention_head_dim"],
                                       hp["kv_channels"],
                                       hp["hybrid_layer_ids"])
    model = tf.Zamba2ForCausalLM(hcfg).float().eval()
    sd = {k: v.detach().clone() for k, v in
          Z.hf_state_dict(params, cfg).items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    with torch.no_grad():
        got = model(input_ids=tokens, use_cache=False).logits
        want = R.logits(sd, hp, tokens)
    _close(want, got, "transformers logits")


@pytest.mark.parametrize("length", [16, 37, 80])
def test_reference_ssd_is_the_recurrence(length):
    """The reference's chunked SSD (chunks of 16) against the recurrence
    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t, y_t = C_t h_t, step by step,
    with the decay weak enough that every chunk carries."""
    g = torch.Generator().manual_seed(length)
    b, h, p, n = 2, 4, 3, 5
    x = torch.randn(b, length, h, p, generator=g)
    dt = 0.05 * torch.rand(b, length, h, generator=g)
    a = -torch.rand(h, generator=g)
    bm = torch.randn(b, length, h, n, generator=g)
    cm = torch.randn(b, length, h, n, generator=g)
    state = torch.zeros(b, h, p, n)
    want = []
    for t in range(length):
        state = torch.exp(dt[:, t] * a)[..., None, None] * state \
            + (dt[:, t, :, None] * x[:, t])[..., None] * bm[:, t, :, None]
        want.append((state * cm[:, t, :, None]).sum(-1))
    _close(R.ssd(x, dt, a, bm, cm, 16), torch.stack(want, 1), "ssd")


def test_the_benchmark_copy_equals_the_reference():
    sys.path.insert(0, str(ROOT))
    try:
        from bench.reference import zamba2 as BR
    finally:
        sys.path.remove(str(ROOT))
    cfg, params, gen = _params(4)
    tokens, labels = _batch(gen)
    sd = Z.hf_state_dict(params, cfg)
    with torch.no_grad():
        assert torch.equal(BR.logits(sd, TINY_HP, tokens),
                           R.logits(sd, TINY_HP, tokens))
        assert torch.equal(BR.loss(sd, TINY_HP, tokens, labels),
                           R.loss(sd, TINY_HP, tokens, labels))
    assert BR.n_params(TINY_HP) == R.n_params(TINY_HP)


def test_no_cache_for_the_released_layout():
    with pytest.raises(NotImplementedError):
        M.init_cache(Z.TINY, 1, 8, device="cpu")


def test_train_run_restores_step_2_bit_for_bit(tmp_path):
    """``launch.train.run`` of TINY: 3 steps with a version at step 2, then
    a run that restores it and takes step 3: the same loss, gradient norm
    and final state, bit for bit."""
    from repro_torch.launch.train import TrainConfig, run

    from repro_torch.core.env import CraftEnv

    env = CraftEnv.capture({"CRAFT_CP_PATH": str(tmp_path / "pfs"),
                            "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
                            "CRAFT_TIER_CHAIN": "node,pfs"})
    tc = TrainConfig(arch="zamba2-7b", tiny=True, steps=3, global_batch=2,
                     seq_len=24, cp_freq=2, device="cpu", seed=11)
    whole = run(tc, env=env)
    assert whole["start_step"] == 0 and len(whole["losses"]) == 3
    resumed = run(TrainConfig(**{**tc.__dict__, "steps": 3}), env=env)
    assert resumed["start_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    assert resumed["grad_norms"] == whole["grad_norms"][2:]
    # (a restore rebuilds the state's dicts in sorted key order)
    got, want = (dict(pytree.tree_flatten_with_path(r["state"])[0])
                 for r in (resumed, whole))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
