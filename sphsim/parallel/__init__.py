from sphsim.parallel.dist import (  # noqa: F401
    exchange_halo,
    make_sharded_dense_step,
    shard_dense_state,
    unshard_dense_state,
)
