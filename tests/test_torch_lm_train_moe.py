"""The MoE configs' losses and gradients, the port against the JAX package
on the CPU (see test_torch_lm_train.py): deepseek-v3 (the router's aux
term, the depth-1 multi-token prediction term, MLA) and arctic (a dense
residual beside the experts), remat, and deepseek's recorded answers."""

import pytest

from _torch_lm_train import (
    check_fixture_equals_reference,
    check_loss_and_grads,
    check_port_replays_fixture,
    check_remat_bit_equal,
)


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "arctic-480b"])
def test_loss_and_grads(name):
    check_loss_and_grads(name)


def test_remat_gives_bit_equal_gradients():
    check_remat_bit_equal("deepseek-v3-671b")


def test_train_fixture_equals_the_reference():
    check_fixture_equals_reference("deepseek-v3-671b")


def test_port_replays_the_train_fixture():
    check_port_replays_fixture("deepseek-v3-671b")
