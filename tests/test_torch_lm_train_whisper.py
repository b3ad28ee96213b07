"""Whisper's training path (the encoder-decoder, the tied head
``embed.T``), the port against the JAX package on the CPU (see
test_torch_lm_train.py): its loss and gradients in float32 and bfloat16,
remat of both stacks, train steps on the embedding pipeline's audio
batches from carried-across weights, and its recorded answers."""

from _torch_lm_train import (
    check_fixture_equals_reference,
    check_loss_and_grads,
    check_port_replays_fixture,
    check_remat_bit_equal,
    check_train_steps,
)

NAME = "whisper-tiny"


def test_loss_and_grads():
    check_loss_and_grads(NAME)


def test_remat_gives_bit_equal_gradients():
    check_remat_bit_equal(NAME)


def test_train_fixture_equals_the_reference_and_the_port_replays_it():
    check_fixture_equals_reference(NAME)
    check_port_replays_fixture(NAME)


def test_train_steps_match_reference():
    check_train_steps(NAME)
