"""Nested checkpoints — the paper's Listing 7 / Fig. 3 / Table 1.

An outer 'continuation' loop (e.g. a parameter sweep) encloses an inner
iterative solve.  Each level gets its own Checkpoint; ``sub_cp`` declares
the parent→child edge so publishing an outer version invalidates stale
inner versions — restarting can never mix outer iteration 2 with inner
state from iteration 1.  The inner state is a tensor here.

    PYTHONPATH=src python -m repro_torch.examples.nested_checkpoints   # crash
    PYTHONPATH=src python -m repro_torch.examples.nested_checkpoints   # resume
"""
import argparse

import torch

from repro_torch.core import Box, Checkpoint
from repro_torch.core.env import CraftEnv

N_L1, L1_FREQ = 2, 1          # paper: nL1iter=2, L1cpFreq=1
N_L2, L2_FREQ = 30, 10        # paper: nL2iter=30, L2cpFreq=10


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    env = CraftEnv.capture({"CRAFT_CP_PATH": "craft-nested",
                            "CRAFT_USE_SCR": "0"})

    l1 = Box(0)
    result = Box(torch.zeros(4, dtype=torch.float64, device=dev))
    cl1 = Checkpoint("CL1", env=env, device=dev)
    cl1.add("l1", l1)
    cl1.add("result", result)
    cl1.commit()

    l2 = Box(0)
    inner = Box(torch.zeros(4, dtype=torch.float64, device=dev))
    cl2 = Checkpoint("CL2", env=env, device=dev)
    cl2.add("l2", l2)
    cl2.add("inner", inner)
    cl2.commit()
    cl1.sub_cp(cl2)           # paper: CL1.subCP(CL2)

    cl1.restart_if_needed()
    crash_once = not (l1.value or l2.value)

    while l1.value < N_L1:
        # restartIfNeeded of the INNER cp runs every outer iteration but
        # only reads on the first call of a restarted run (paper §2.5)
        cl2.restart_if_needed()
        if l2.value:
            print(f"  resumed inner loop at l2={l2.value} (outer {l1.value})")
        while l2.value < N_L2:
            inner.value += 1.0
            l2.value += 1
            cl2.update_and_write(l2.value, L2_FREQ)
            if crash_once and l1.value == 1 and l2.value == 15:
                print("simulated crash at outer=1, inner=15 — run me again; "
                      "I must resume at outer=1, inner=10 (NOT inner=30 of "
                      "outer 0 — paper Table 1 stage V)")
                cl1.close()
                cl2.close()
                return
        result.value += inner.value
        inner.value.zero_()
        l2.value = 0
        l1.value += 1
        cl1.update_and_write(l1.value, L1_FREQ)   # invalidates CL2 versions

    print(f"done: result={result.value.cpu().numpy()} (expect "
          f"{[float(N_L1 * N_L2)] * 4})")
    cl1.close()
    cl2.close()


if __name__ == "__main__":
    main()
