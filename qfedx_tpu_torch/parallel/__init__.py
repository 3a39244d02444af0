"""Meshes of slots and the slot-sharded statevector (counterpart of
``qfedx_tpu/parallel``), inside one process and across processes."""

from qfedx_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardCtx,
    apply_cnot_sharded,
    apply_gate_2q_sharded,
    apply_gate_sharded,
    expect_z_all_sharded,
    expect_z_sharded,
    from_dense,
    norm_sq_sharded,
    pmean_grad,
    product_state_local,
    swap_global_local,
    zero_state_local,
)
from qfedx_tpu_torch.parallel.circuit import (  # noqa: F401
    make_sharded_forward,
    sharded_hea_state,
)
from qfedx_tpu_torch.parallel.mesh import (  # noqa: F401
    distributed_init,
    fed_mesh,
    hybrid_fed_mesh,
    sv_process_groups,
)
