"""Write the JAX-written orbax fixture and its npz twin (tests/data/).

The JAX package saves one training state twice: as an orbax directory
(``checkpoint_format = orbax``, the table and accumulator row-sharded over a
2-way row mesh, so the table is stored as two chunks in the per-process
database and referenced from the root) and as an npz file, both with the
same input cursor.  The state is baseline5's model (order-3 FM, factor_num
8: rows of 9) at a vocabulary of 4,096 rows, its arrays drawn from a numpy
seed.  ``tests/test_torch_orbax.py`` and ``chip_smoke.py`` restore both
through the port and hold them bitwise equal.

    python tools/make_orbax_fixture.py [--out tests/data] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=2").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fast_tffm_tpu.checkpoint import save_checkpoint  # noqa: E402
from fast_tffm_tpu.config import build_model, load_config  # noqa: E402
from fast_tffm_tpu.trainer import init_state  # noqa: E402

NAME = "jax_b5_rowmesh"
VOCAB = 4096
STEP = 37
CURSOR = {"version": 1, "epoch": 1, "batch_in_epoch": 5, "batch_size": 16384,
          "shuffle": False, "shuffle_seed": 0, "steps_per_call": 1, "files": "fixture"}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("tests", "data"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs", "baseline5_fm_order3_kdd.cfg"))
    cfg.vocabulary_size = VOCAB
    model = build_model(cfg)
    rng = np.random.default_rng(args.seed)
    state = init_state(model, jax.random.key(args.seed))
    state = state._replace(
        table=jnp.asarray(rng.uniform(-0.05, 0.05, (VOCAB, model.row_dim)).astype(np.float32)),
        table_opt=state.table_opt._replace(
            accum=jnp.asarray(rng.uniform(0.1, 2.0, (VOCAB, model.row_dim)).astype(np.float32))),
        step=jnp.asarray(STEP, jnp.int32),
    )
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "row"))
    rows = NamedSharding(mesh, PartitionSpec("row", None))
    rep = NamedSharding(mesh, PartitionSpec())
    sharded = jax.tree.map(lambda x: jax.device_put(x, rep), state)
    sharded = sharded._replace(
        table=jax.device_put(state.table, rows),
        table_opt=state.table_opt._replace(accum=jax.device_put(state.table_opt.accum, rows)),
    )
    os.makedirs(args.out, exist_ok=True)
    orbax_dir = os.path.abspath(os.path.join(args.out, NAME + ".orbax"))
    shutil.rmtree(orbax_dir, ignore_errors=True)
    save_checkpoint(orbax_dir, sharded, "orbax", cursor=CURSOR)
    save_checkpoint(os.path.join(args.out, NAME + ".npz"), state, "npz", cursor=CURSOR)
    total = 0
    for root, _, files in os.walk(args.out):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files
                     if NAME in os.path.join(root, f))
    print(f"wrote {orbax_dir} and its npz twin: {total} bytes")


if __name__ == "__main__":
    main()
