"""The paper's showcase (§5/§6): a Lanczos eigensolver on an on-the-fly
graphene Hamiltonian, with CRAFT checkpoint/restart AND automatic fault
tolerance, on the port.

Three modes:

    PYTHONPATH=src python -m repro_torch.examples.lanczos_aft               # plain CR
    PYTHONPATH=src python -m repro_torch.examples.lanczos_aft --fail-at 45  # crash+rerun
    PYTHONPATH=src python -m repro_torch.examples.lanczos_aft --aft         # AFT zone:
        2 simulated ranks, rank 0 fail-stops mid-run, the zone repairs the
        communicator (non-shrinking spawn) and the restarted body resumes
        from the latest checkpoint — paper Fig. 8's scenario.

``--device cpu`` runs off the card.
"""
import argparse

from repro_torch.apps.lanczos import GrapheneConfig, aft_lanczos, run_lanczos
from repro_torch.core.env import CraftEnv


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--cp-freq", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--aft", action="store_true")
    ap.add_argument("--cp-dir", default="craft-lanczos")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = GrapheneConfig(nx=args.nx, ny=args.nx, disorder=0.3)
    if args.aft:
        # the failure hook lives with the app (apps/lanczos.py); rank 0
        # raises ProcFailedError at iteration iters // 2, as in the reference
        fail_at = args.iters // 2
        print(f"  !! injecting rank-0 failure at iteration {fail_at}")
        out = aft_lanczos(args.cp_dir, cfg, args.iters, args.cp_freq, fail_at,
                          device=args.device, timeout=900)
        for r in out["members"]:
            print(f"  member {r['rank']}: eig={r['eig']:.6f} "
                  f"wall={r['wall_s']:.2f}s resumed_from={r['resumed_from']}")
        return

    env = CraftEnv.capture({
        "CRAFT_CP_PATH": args.cp_dir, "CRAFT_USE_SCR": "0",
        "CRAFT_COMM_RECOVERY_POLICY": "NON-SHRINKING"})
    res = run_lanczos(cfg, n_iter=args.iters, cp_freq=args.cp_freq,
                      env=env, fail_at=args.fail_at, device=args.device)
    print(f"min eigenvalue ≈ {res.eigenvalue:.6f} "
          f"({res.iterations} iterations, {res.wall_s:.2f}s, "
          f"restarted_at={res.restarted_at})")
    if res.cp_stats:
        print(f"checkpoint stats: {res.cp_stats}")


if __name__ == "__main__":
    main()
