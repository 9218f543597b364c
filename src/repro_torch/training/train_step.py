"""The training step (PyTorch port of ``repro.training.train_step``):
loss -> autograd backward -> global-norm clip -> optimizer update.

It runs unchanged on DTensor parameters and optimizer state (a sharded
run, ``launch.train --mesh``): each gradient is laid out as its parameter
(the data-parallel sum: a reduce-scatter or all-reduce), the optimizer
works on the local shards (``optimizer``), and the metrics come back as
plain full values."""

from __future__ import annotations

import torch

from ..models import model as model_lib
from ..sharding import local as shlocal
from ..tree import tree_map, tree_paths, tree_set
from . import optimizer as opt_lib


def make_train_step(cfg, opt: opt_lib.Optimizer, *, remat: bool = True,
                    clip_norm: float = 1.0):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  The parameters and the optimizer state are updated in
    place (and returned); the first call marks every parameter
    ``requires_grad``.  ``metrics``: ``model.lm_loss``'s plus
    ``grad_norm``, the norm before clipping, detached float32 scalars on
    the device."""

    def train_step(params, opt_state, batch):
        paths = tree_paths(params)
        leaves = [p.requires_grad_(True) for _, p in paths]
        loss, metrics = model_lib.lm_loss(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        tree = tree_map(lambda p: None, params)
        for (path, p), g in zip(paths, grads):
            if shlocal.is_dtensor(g):
                g = g.redistribute(p.device_mesh, p.placements)
            tree_set(tree, path, g)
        del grads, loss
        with torch.no_grad():
            tree, grad_norm = opt_lib.clip_by_global_norm(tree, clip_norm)
            updates, opt_state = opt.update(tree, opt_state, params)
            del tree
            opt_lib.apply_updates(params, updates)
        metrics = {k: _full(v.detach()) for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return params, opt_state, metrics

    return train_step


def _full(v):
    return v.full_tensor() if shlocal.is_dtensor(v) else v


def make_eval_step(cfg):
    """Returns eval_step(params, batch) -> ``model.lm_loss``'s metrics,
    without autograd."""

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = model_lib.lm_loss(params, cfg, batch, remat=False)
        return {k: _full(v) for k, v in metrics.items()}

    return eval_step
