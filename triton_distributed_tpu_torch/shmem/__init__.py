"""The port's one-sided transport, host side (counterpart of
triton_distributed_tpu/shmem; the device side is csrc/tdt_shmem.cuh)."""

from .primitives import (  # noqa: F401
    FAULT_NONE,
    FAULT_TIMEOUT,
    WAIT_BUDGET_S,
    WIRE_CODES,
    Workspace,
    a2a_workspace,
    check_faults,
    coll_block,
    coll_wire_group,
    coll_wire_workspace,
    coll_workspace,
    launch_a2a,
    launch_coll,
    launch_ll,
    launch_sp_ag,
    ll_workspace,
    launch_tp,
    release_workspaces,
    sp_ag_workspace,
    wire_workspace,
    workspace,
)
