from .mesh import (
    DataMesh,
    all_reduce_grads,
    barrier,
    broadcast_module,
    broadcast_object,
    check_replicas,
    create_mesh,
    init_distributed,
    is_primary,
)
