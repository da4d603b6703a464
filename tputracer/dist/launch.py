"""Multi-host entry points (SURVEY.md §2 "distributed communication
backend", §5 failure detection).

The reference is a single CPU process; the framework's multi-host story
is JAX's multi-controller SPMD: every host process runs the same
program, ``jax.distributed.initialize`` wires them into one cluster via
the coordination service, and the jit/shard_map code in dist.mesh runs
unchanged over the global device mesh — NVLink within a host, the
network across hosts, both behind the same collective API.

CPU processes (tests/distributed/test_multiprocess.py) exercise the
exact same code path with ``--xla_force_host_platform_device_count``
standing in for local chips, so the multi-host wiring is CI-testable
without a cluster.
"""

from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, **kw):
    """Join (or form) a multi-host cluster.

    Pass all three explicitly (nothing detects a GPU cluster), e.g.
    coordinator_address="localhost:1234" for processes of one host.  Must run before any backend
    use.  Idempotent-ish: raises if already initialized.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )


def shutdown():
    jax.distributed.shutdown()


def replicate_global(tree, mesh):
    """Place a host-local pytree (identical on every process, e.g. a
    Scene built deterministically) as globally-replicated jax.Arrays on
    the mesh — the input form jit needs in multi-controller mode."""
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)
