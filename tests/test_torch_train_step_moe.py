"""PyTorch port: the training step against ``repro.models.model.lm_loss``
and ``jax.grad`` for the MoE stacks (kimi-k2: a dense prefix layer, then
MoE layers with a shared expert; mixtral: MoE with a sliding window) and
the sliding-window dense stack (h2o-danube), on float32 smoke configs;
the checks and their tolerances are test_torch_train_step.py's."""

import pytest

pytest.importorskip("torch")

from test_torch_train_step import (  # noqa: E402,F401
    check_loss_and_grads, check_remat, check_train_step, family, one_thread)

NAMES = ["kimi-k2-1t-a32b", "mixtral-8x22b", "h2o-danube-3-4b"]


@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_and_grads(family, name):  # noqa: F811
    check_loss_and_grads(family(name))


@pytest.mark.parametrize("name", NAMES)
def test_train_step(family, name):  # noqa: F811
    check_train_step(family(name))


@pytest.mark.parametrize("name", NAMES)
def test_remat_equals_no_remat(family, name):  # noqa: F811
    check_remat(family(name))
