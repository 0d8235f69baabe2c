"""End to end: train a ~100M-param LM with CRAFT CR + AFT, on the
port (``repro_torch.launch.train``).

Default preset is a ~134M-parameter llama-style model (the h2o-danube
architecture scaled down) trained for a few hundred steps on the synthetic
Zipfian pipeline, checkpointing every 25 steps.  ``--inject-failure`` runs
the whole loop inside an AFT zone on the 2-rank simulator backend and
fail-stops rank 0 mid-run: the zone recovers (non-shrinking), re-reads the
checkpoint, and finishes — the paper's Listing 9 at framework scale.

    PYTHONPATH=src python -m repro_torch.examples.train_with_failures --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_with_failures --smoke
    PYTHONPATH=src python -m repro_torch.examples.train_with_failures --smoke \\
        --inject-failure

``--schedule daly`` replaces the fixed 25-step frequency with the adaptive
scheduler: every chained tier checkpoints on its own Young/Daly interval
derived from its measured write cost and ``--mtbf``, and a
``CRAFT_WALLTIME_SECONDS`` budget (``--walltime``) lands one final full
checkpoint before the job dies.  ``--device cpu`` runs off the card.
"""
import argparse
import os
import time

import torch

from repro_torch.configs import get_config, register_config
from repro_torch.core.env import CraftEnv
from repro_torch.launch import train as T


def build_100m():
    """~134M params: 12 layers, d=768, GQA 12/4 heads, d_ff 2048."""
    base = get_config("h2o-danube-1.8b")
    return base.replace(
        arch_id="danube-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32000, window=1024,
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config + 30 steps (seconds, not minutes)")
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--cp-dir", default="craft-train-100m")
    ap.add_argument("--schedule", choices=("fixed", "daly"), default="fixed",
                    help="fixed = every 25 steps; daly = per-tier adaptive "
                         "intervals (CRAFT_TIER_EVERY=auto)")
    ap.add_argument("--mtbf", type=float, default=600.0,
                    help="assumed MTBF seconds feeding the Daly formula")
    ap.add_argument("--walltime", type=float, default=0.0,
                    help="job walltime budget seconds (0 = no guard); the "
                         "policy lands one final full checkpoint before it")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        # deterministic kernels: a resumed run repeats the uninterrupted one
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    if args.smoke:
        arch, tiny, steps, gb, sl = "h2o-danube-1.8b", True, 30, 4, 64
    else:
        register_config("danube-100m", build_100m())
        arch, tiny, steps, gb, sl = "danube-100m", False, args.steps, 8, 512

    envmap = {
        "CRAFT_CP_PATH": args.cp_dir,
        "CRAFT_USE_SCR": "0",
        "CRAFT_WRITE_ASYNC": "1",           # paper §2.4 async checkpointing
        "CRAFT_COMM_RECOVERY_POLICY": "NON-SHRINKING",
    }
    if args.schedule == "daly":
        envmap["CRAFT_TIER_EVERY"] = "auto"
        envmap["CRAFT_MTBF_SECONDS"] = str(args.mtbf)
    if args.walltime > 0:
        envmap["CRAFT_WALLTIME_SECONDS"] = str(args.walltime)
        envmap["CRAFT_WALLTIME_MARGIN_SECONDS"] = "5"
    env = CraftEnv.capture(envmap)
    n_params = get_config(arch, tiny=tiny).param_count()
    print(f"arch={arch} ({n_params / 1e6:.0f}M params), steps={steps}")

    tc = T.TrainConfig(
        arch=arch, tiny=tiny, steps=steps, global_batch=gb, seq_len=sl,
        # daly mode drops the fixed gate: the policy alone decides cadence
        cp_freq=1 if args.schedule == "daly" else 25,
        fail_at_step=steps // 2 if args.inject_failure else None,
        device=args.device)

    t0 = time.time()
    log_every = max(1, steps // 20)

    def on_step(step, metrics):
        if step % log_every == 0:
            print(f"  step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"({(time.time() - t0) / step:.2f}s/step)")

    if args.inject_failure:
        from repro_torch.core.comm_sim import SimWorld

        world = SimWorld(2, spare_nodes=1, env=env)

        def worker(comm):
            return T.run(tc, comm=comm, env=env,
                         on_step=on_step if comm.rank == 0 else None)

        results = world.run(worker, timeout=3600)
        out = next(iter(results.values()))
        print(f"recovered and finished: step {out['final_step']}, "
              f"final loss {out['losses'][-1]:.4f}")
    else:
        out = T.run(tc, env=env, on_step=on_step)
        print(f"finished: step {out['final_step']}, "
              f"final loss {out['losses'][-1]:.4f}, "
              f"wall {out['wall_s']:.1f}s, cp stats {out['stats']}")


if __name__ == "__main__":
    main()
