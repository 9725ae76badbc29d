from .mesh import (
    Mesh,
    RowGenerator,
    all_reduce_mean_grads,
    chunk_rows,
    default_mesh,
    gather_rows,
    host_batch_rows,
    make_dp_epoch_runner,
    make_dp_eval_render,
    make_dp_train_step,
    make_mesh,
    replicate_tree,
    shard_batch,
    shard_host_batch,
)

__all__ = [
    "Mesh", "RowGenerator", "make_mesh", "default_mesh", "shard_batch",
    "shard_host_batch", "host_batch_rows", "replicate_tree",
    "all_reduce_mean_grads", "chunk_rows", "gather_rows",
    "make_dp_train_step", "make_dp_epoch_runner",
    "make_dp_eval_render",
]
