"""The JAX overfit recipe's initial training state, as an orbax checkpoint.

tools_local_overfit.py builds DETRPose-N in bf16 and starts from JAX
``init_train_state`` with PRNGKey(0) on a 128 px sample. This writes that
state (or the one from another key) with JAX ``save_checkpoint``, so that the
port's overfit tool (``detrpose_tpu_torch/tools/overfit.py --init DIR``)
trains from the very weights the JAX recipe starts from:

  PYTHONPATH=. python tests/jax_overfit_init.py OUT_DIR [KEY]
"""
import sys

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model, model_config
from detrpose_tpu.parallel import init_train_state
from detrpose_tpu.train.optim import make_optimizer
from detrpose_tpu.utils.checkpoint import save_checkpoint


def save_jax_overfit_init(path: str, key: int = 0) -> None:
    model = build_model(model_config("n", dtype=jnp.bfloat16))
    sample = jnp.zeros((1, 128, 128, 3))
    params_shape = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), sample,
                                                     train=True))["params"]
    state = init_train_state(model, make_optimizer(params_shape), jax.random.PRNGKey(key),
                             sample)
    save_checkpoint(path, state, epoch=0)


if __name__ == "__main__":
    save_jax_overfit_init(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 0)
