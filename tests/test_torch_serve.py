"""The port's serving driver against the reference's, on the CPU.

A float32 TINY configuration of each served architecture is registered in
both packages under one name and served with the same weights (the
reference's ``init_params``, carried over with
``convert.params_from_numpy``) and the same prompts (both drivers draw them
from ``np.random.default_rng(seed)``).  Greedy tokens must be identical.
A decode checkpoint (cache, generated tokens, position) written by either
package when a run fails mid-generation resumes in the other with the same
``resumed_at`` and the same tokens.  deepseek's MLA decodes on both of the
reference's routes (``mla_absorb`` True, the default, and False).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import register_config as ref_register
from repro.core.env import CraftEnv as RefEnv
from repro.launch import serve as ref_serve
from repro.models import model as RM

from repro_torch import convert
from repro_torch.configs import get_config, register_config
from repro_torch.core import CraftEnv
from repro_torch.launch import serve

ARCHS = ["h2o-danube-1.8b", "zamba2-2.7b", "falcon-mamba-7b",
         "deepseek-v3-671b", "kimi-k2-1t-a32b"]
GEN, CP_FREQ, FAIL_AT = 8, 4, 6
ROOT = Path(__file__).resolve().parents[1]


def _name(arch: str, absorb: bool = True) -> str:
    return f"{arch}-tiny-f32" + ("" if absorb else "-expanded")


@functools.lru_cache(maxsize=None)
def _weights(arch: str, absorb: bool = True):
    """Register the float32 TINY config in both packages (``absorb``: its
    ``mla_absorb``); return the reference's weights and the same weights in
    the port."""
    tiny = ref_config(arch, tiny=True).replace(param_dtype="float32",
                                               mla_absorb=absorb)
    ref_register(_name(arch, absorb), tiny, tiny)
    port_tiny = get_config(arch, tiny=True).replace(param_dtype="float32",
                                                    mla_absorb=absorb)
    register_config(_name(arch, absorb), port_tiny, port_tiny)
    rparams = RM.init_params(jax.random.PRNGKey(0), tiny)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), port_tiny, "cpu")
    return rparams, params


def _configs(arch: str, absorb: bool = True, **kw):
    common = dict(arch=_name(arch, absorb), batch=2, prompt_len=40,
                  gen_tokens=GEN, **kw)
    return ref_serve.ServeConfig(**common), serve.ServeConfig(
        **common, device="cpu")


def _envs(path: Path):
    knobs = {"CRAFT_CP_PATH": str(path / "pfs"),
             "CRAFT_NODE_CP_PATH": str(path / "node")}
    return RefEnv.capture(knobs), CraftEnv.capture(knobs)


@functools.lru_cache(maxsize=None)
def _reference_tokens(arch: str, absorb: bool = True) -> np.ndarray:
    rparams, _ = _weights(arch, absorb)
    ref_sc, _ = _configs(arch, absorb)
    return ref_serve.run(ref_sc, params=rparams)["tokens"]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch):
    _, params = _weights(arch)
    _, sc = _configs(arch)
    out = serve.run(sc, params=params)
    assert out["resumed_at"] == 0 and out["logits_finite"]
    assert out["tokens"].shape == (2, GEN)
    np.testing.assert_array_equal(out["tokens"], _reference_tokens(arch))


def test_mla_expanded_decode_tokens_match_reference():
    """deepseek with ``mla_absorb=False``: the re-expanded cache through the
    attention op (the reference's ``attention_ref``) gives the reference's
    greedy tokens, which are the absorbed route's tokens too."""
    _, params = _weights("deepseek-v3-671b", False)
    _, sc = _configs("deepseek-v3-671b", False)
    out = serve.run(sc, params=params)
    want = _reference_tokens("deepseek-v3-671b", False)
    np.testing.assert_array_equal(out["tokens"], want)
    np.testing.assert_array_equal(want,
                                  _reference_tokens("deepseek-v3-671b"))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_resumes_in_the_port(arch, tmp_path):
    rparams, params = _weights(arch)
    ref_sc, sc = _configs(arch, cp_freq=CP_FREQ)
    ref_env, env = _envs(tmp_path)
    with pytest.raises(RuntimeError, match="injected failure"):
        ref_serve.run(ref_sc, env=ref_env, params=rparams,
                      fail_at_token=FAIL_AT)
    out = serve.run(sc, env=env, params=params)
    assert out["resumed_at"] == CP_FREQ
    np.testing.assert_array_equal(out["tokens"], _reference_tokens(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_resumes_in_the_reference(arch, tmp_path):
    rparams, params = _weights(arch)
    ref_sc, sc = _configs(arch, cp_freq=CP_FREQ)
    ref_env, env = _envs(tmp_path)
    with pytest.raises(RuntimeError, match="injected failure"):
        serve.run(sc, env=env, params=params, fail_at_token=FAIL_AT)
    out = ref_serve.run(ref_sc, env=ref_env, params=rparams)
    assert out["resumed_at"] == CP_FREQ
    np.testing.assert_array_equal(out["tokens"], _reference_tokens(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_resume_equals_uninterrupted_run(arch, tmp_path):
    """bfloat16 TINY with random port weights and the device snapshot
    path: fail at token 6, resume from the checkpoint at token 4."""
    sc = serve.ServeConfig(arch=arch, batch=2, prompt_len=40, gen_tokens=GEN,
                           device="cpu", seed=3)
    clean = serve.run(sc)
    env = CraftEnv.capture({"CRAFT_CP_PATH": str(tmp_path / "pfs"),
                            "CRAFT_TIER_CHAIN": "pfs",
                            "CRAFT_DEVICE_SNAPSHOT": "1"})
    sc = dataclasses.replace(sc, cp_freq=CP_FREQ)
    with pytest.raises(RuntimeError, match="injected failure"):
        serve.run(sc, env=env, fail_at_token=FAIL_AT)
    out = serve.run(sc, env=env)
    assert out["resumed_at"] == CP_FREQ and out["logits_finite"]
    assert [i for i, _ in out["cp_writes"]] == [8]
    np.testing.assert_array_equal(out["tokens"], clean["tokens"])
    np.testing.assert_array_equal(out["last_logits"], clean["last_logits"])


def test_sampling_is_seeded():
    sc = serve.ServeConfig(arch="falcon-mamba-7b", batch=2, prompt_len=8,
                           gen_tokens=6, device="cpu", temperature=1.0)
    a, b = serve.run(sc), serve.run(sc)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = serve.run(dataclasses.replace(sc, seed=1))
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_a_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request would be served")
    sc = serve.ServeConfig(arch="h2o-danube-1.8b", batch=1, prompt_len=4,
                           gen_tokens=1)          # device="cuda", the default
    with pytest.raises(RuntimeError):
        serve.run(sc)


def test_serve_command_line():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "zamba2-2.7b", "--batch", "2", "--prompt-len", "8",
         "--gen", "4"], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "resumed_at=0" in out.stdout and "first sequence" in out.stdout
