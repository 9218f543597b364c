"""PyTorch port: the training step against ``repro.models.model.lm_loss``
and ``jax.grad`` for the recurrent stacks (mamba2: Mamba-2 SSD mixers;
recurrentgemma: RG-LRU blocks and local attention), on float32 smoke
configs; the checks and their tolerances are test_torch_train_step.py's."""

import pytest

pytest.importorskip("torch")

from test_torch_train_step import (  # noqa: E402,F401
    check_loss_and_grads, check_remat, check_train_step, family, one_thread)

NAMES = ["mamba2-1.3b", "recurrentgemma-9b"]


@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_and_grads(family, name):  # noqa: F811
    check_loss_and_grads(family(name))


@pytest.mark.parametrize("name", NAMES)
def test_train_step(family, name):  # noqa: F811
    check_train_step(family(name))


@pytest.mark.parametrize("name", NAMES)
def test_remat_equals_no_remat(family, name):  # noqa: F811
    check_remat(family(name))
