"""bf16 training of jamba-v0.1-52b's period kind (Mamba mixers, one
attention sublayer, MoE layers) against the JAX package's, by the witness
rule of tests/test_torch_bf16_train.py, in a file of its own so that its
JAX traces run beside that file's."""
from test_torch_bf16_train import check_loss_and_grads


def test_bf16_period_loss_and_grads_within_the_witness():
    check_loss_and_grads("jamba-v0.1-52b")
