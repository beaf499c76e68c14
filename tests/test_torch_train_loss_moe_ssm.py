"""tests/test_torch_train_loss.py's checks of `Model.loss_fn` and its
gradients against `jax.value_and_grad` of the JAX package's, on the
reduced configs of the zamba2 (the Mamba scan's plain version under
autograd), moe (the dispatch's sorts, scatters and capacity drops: the
gradient reaches the router as `jax.grad` has it) and xlstm patterns, as
they are and through the chunked cross-entropy; the masked loss on a MoE
config. Same tolerances (LOSS_TOL, GRAD_TOL), stated there."""
import pytest
import torch

from test_torch_train_loss import no_kernel_launch  # noqa: F401 (autouse)
from test_torch_train_loss import \
    test_loss_fn_and_grads_match_jax as _check_loss_and_grads
from test_torch_train_loss import test_masked_loss_matches_jax as _check_mask

torch.set_num_threads(1)

ARCHS = ["zamba2-1.2b", "granite-moe-1b-a400m", "granite-moe-3b-a800m",
         "xlstm-350m"]


@pytest.mark.parametrize("variant", ["plain", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch, variant):
    _check_loss_and_grads(arch, variant)


def test_masked_loss_matches_jax():
    _check_mask("granite-moe-1b-a400m")
