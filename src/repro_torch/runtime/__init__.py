"""Multi-process fault-tolerant runtime (the paper's testbed analog),
ported from ``repro.runtime``.

A :class:`~repro_torch.runtime.cluster.Cluster` runs N worker *processes* grouped
into logical *nodes* (``procs_per_node``) with an optional spare-node pool.
The coordinator (threads in the launching process — the role a job scheduler
/ Borg-Pathways control plane plays on a real fleet) mediates collectives,
detects fail-stop failures via connection EOF + heartbeat staleness +
collective deadlines (straggler mitigation), and executes the ULFM recovery
recipe with REUSE / NO-REUSE spawn policies.

Fault model (paper §5.3): ``cluster.kill(rank)`` / ``cluster.kill_node(n)``
deliver SIGKILL — the paper's ``pkill -9`` — and in-application injection is
available by raising from the worker fn.

Workers are separate processes, so on a CUDA card each holds its own
context: a SIGKILL takes the process's device memory and any write it had
in flight with it.  Only host values cross the coordinator connection.
"""
from repro_torch.runtime.cluster import Cluster  # noqa: F401
