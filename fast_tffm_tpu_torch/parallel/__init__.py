"""Mesh-sharded training and prediction on ``torch.distributed`` — the
counterpart of ``fast_tffm_tpu/parallel/``: one rank per process and
device, a ``[data, row]`` grid of ranks (``mesh``), the row-sharded table
(``embedding``, ``alltoall``) and the sharded steps (``train_step``)."""

from fast_tffm_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    ROW_AXIS,
    Mesh,
    check_batch_divides,
    make_mesh,
    pad_vocab,
)
from fast_tffm_tpu_torch.parallel.train_step import (  # noqa: F401
    gather_logical_state,
    gather_touched_rows,
    init_sharded_state,
    make_sharded_predict_step,
    make_sharded_train_step,
    packed_shard_meta,
    shard_meta,
    shard_state,
)
