from .mesh import (  # noqa: F401
    Mesh,
    gather,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_batch,
    sharded_commit,
    sharded_gk_dvalues,
    sharded_gk_recombine,
    sharded_gk_total,
    sharded_msm,
)
