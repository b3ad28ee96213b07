"""The losses and gradients of the transformer configs besides llama,
the port against the JAX package on the CPU (see test_torch_lm_train.py):
``check_loss_and_grads``'s float32 and bfloat16 bounds at the smoke size,
on weights from ``seeded_numpy_params`` taken by both packages."""

import pytest

from _torch_lm_train import check_loss_and_grads


@pytest.mark.parametrize("name", ["gemma3-1b", "phi3-mini-3.8b", "granite-20b",
                                  "llava-next-mistral-7b"])
def test_loss_and_grads(name):
    check_loss_and_grads(name)
