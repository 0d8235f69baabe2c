"""Quickstart — the paper's Listing 2, on a torch tensor state.

A toy iterative application gains application-level checkpoint/restart with
five lines: define a Checkpoint, add() the state, commit(), restart, and
the need_checkpoint()/update_and_write() pair inside the loop — the policy
(core/scheduler.py) decides when and to which tiers a version is written;
``cp_freq`` here is the paper's fixed-frequency gate layered on top.  Run
it twice to see the restart:

    PYTHONPATH=src python -m repro_torch.examples.quickstart   # crashes at 55
    PYTHONPATH=src python -m repro_torch.examples.quickstart   # resumes at 50

``--device cpu`` keeps the tensor (and the checkpoint digests) off the card.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Box, Checkpoint
from repro_torch.core.env import CraftEnv


def modify_data(dbl: Box, arr: np.ndarray, state: Box) -> None:
    """The 'computation-communication loop' body of paper Listing 1."""
    dbl.value += 0.5
    arr += 1
    state.value = torch.sin(state.value + dbl.value)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    # Checkpoints land under ./craft-quickstart (CRAFT_CP_PATH analog).
    env = CraftEnv.capture({"CRAFT_CP_PATH": "craft-quickstart",
                            "CRAFT_USE_SCR": "0"})
    n = 5
    iteration = Box(1)                       # paper: int iteration
    dbl = Box(0.0)                           # paper: double dbl
    data_arr = np.zeros(n)                   # paper: int* dataArr
    state = Box(torch.zeros((4, 4), device=args.device))   # a tensor

    # ============ DEFINE CHECKPOINT (paper Listing 2) ============
    my_cp = Checkpoint("myCP", env=env, device=args.device)
    my_cp.add("dbl", dbl)
    my_cp.add("iteration", iteration)
    my_cp.add("dataArr", data_arr)
    my_cp.add("state", state)
    my_cp.commit()
    restarted = my_cp.restart_if_needed()
    if restarted:
        print(f"restarted from iteration {iteration.value} "
              f"(checkpoint v-{my_cp.version})")
    # =============================================================

    cp_freq = 10
    while iteration.value <= 100:
        modify_data(dbl, data_arr, state)
        if iteration.value == 55 and not restarted:
            print("simulating a crash at iteration 55 — run me again!")
            my_cp.close()
            return
        iteration.value += 1
        # the policy API: probe the scheduler, then write (the probe is
        # optional — update_and_write() evaluates the same cached decision)
        if my_cp.need_checkpoint(iteration.value, cp_freq):
            my_cp.update_and_write(iteration.value, cp_freq)

    print(f"done: iteration={iteration.value - 1}, dbl={dbl.value}, "
          f"dataArr={data_arr}, |state|={float(torch.sum(state.value)):.4f}")
    print(f"checkpoint stats: {my_cp.stats}")
    my_cp.close()


if __name__ == "__main__":
    main()
