"""Shape-only stand-ins and step functions for the dry run (PyTorch port of
``repro.launch.specs``).

``input_specs(cfg, shape)`` returns fake tensors (``FakeTensorMode``) for
every argument of the step of an assigned input shape: they carry shape,
dtype and device and allocate nothing, so a step of a published config
on a 256-rank mesh runs on the host.  The stand-ins come from the port's
own constructors (``model.init_params``, ``transformer.init_cache``,
``optimizer.make_optimizer(...).init``) run under the fake mode, so they
are what a real run would build; ``input_specs`` hands the mode back in
its ``meta`` so the caller runs the step under the same one.

Step selection per ``shape.kind``, as in the reference:
    train    -> train_step(params, opt_state, batch)   (remat per layer)
    prefill  -> prefill(params, batch)          (builds cache + last logits)
    decode   -> decode_step(params, cache, tok) (ONE token, cache = seq_len)

Unlike the reference's functional steps, the port's update their state in
place: the train step the parameters and optimizer state, decode the
cache (what the reference donates).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import InputShape, ModelConfig
from ..models import model as model_lib, transformer
from ..training import optimizer as opt_lib, train_step as ts_lib


def fake_mode():
    """A fresh ``FakeTensorMode`` (imported here, not with the module)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def text_len(cfg: ModelConfig, shape: InputShape) -> int:
    """Token positions available for text after modality prefix tokens."""
    if cfg.frontend == "vision":
        return shape.seq_len - cfg.num_patch_tokens
    return shape.seq_len


def _prefill_len(cfg: ModelConfig, shape: InputShape) -> int:
    return text_len(cfg, shape) + (cfg.num_patch_tokens
                                   if cfg.frontend == "vision" else 0)


def batch_specs(cfg: ModelConfig, shape: InputShape, mode,
                device="cpu") -> dict:
    """The train/prefill batch as fake tensors of ``mode``."""
    B, S = shape.global_batch, text_len(cfg, shape)
    with mode:
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                       device=device)}
        if shape.kind == "train":
            batch["labels"] = torch.empty((B, S), dtype=torch.int32,
                                          device=device)
        if cfg.frontend == "vision":
            batch["patches"] = torch.empty(
                (B, cfg.num_patch_tokens, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        if cfg.family == "encdec":
            batch["frames"] = torch.empty(
                (B, cfg.encoder_seq_len, cfg.d_model),
                dtype=torch.bfloat16, device=device)
    return batch


def params_specs(cfg: ModelConfig, mode, device="cpu") -> dict:
    """``model.init_params``'s tree as fake tensors of ``mode``."""
    with mode:
        return model_lib.init_params(cfg, torch.Generator(device), device)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, mode,
                device="cpu") -> dict:
    """``transformer.init_cache``'s bf16 tree as fake tensors of ``mode``."""
    with mode:
        return transformer.init_cache(cfg, batch, max_len, torch.bfloat16,
                                      device)


def step_optimizer(cfg: ModelConfig):
    """The optimizer of the dry run's train step: the config's default
    (AdamW, or Adafactor past 50 B parameters), lr 3e-4, as the
    reference's dry run takes it."""
    return opt_lib.make_optimizer(opt_lib.default_optimizer_name(cfg), 3e-4,
                                  cfg)


def input_specs(cfg: ModelConfig, shape: InputShape,
                device="cpu") -> Tuple[tuple, dict]:
    """Returns (args, meta): args are the positional fake-tensor arguments
    of the step ``make_step_fn`` produces; ``meta["fake_mode"]`` is the
    mode they belong to (run the step under it)."""
    mode = fake_mode()
    meta = {"fake_mode": mode}
    params = params_specs(cfg, mode, device)
    if shape.kind == "train":
        with mode:
            opt_state = step_optimizer(cfg).init(params)
        return (params, opt_state, batch_specs(cfg, shape, mode, device)), \
            meta
    if shape.kind == "prefill":
        return (params, batch_specs(cfg, shape, mode, device)), meta
    # decode: ONE new token against a cache of seq_len
    B = shape.global_batch
    cache = cache_specs(cfg, B, shape.seq_len, mode, device)
    with mode:
        token = torch.empty((B, 1), dtype=torch.int32, device=device)
    return (params, cache, token), meta


def make_step_fn(cfg: ModelConfig, shape: InputShape):
    """The function the dry run runs, matching input_specs' args."""
    if shape.kind == "train":
        return ts_lib.make_train_step(cfg, step_optimizer(cfg), remat=True)
    if shape.kind == "prefill":
        S = _prefill_len(cfg, shape)

        def prefill_fn(params, batch):
            return model_lib.prefill(params, cfg, batch["tokens"], S,
                                     patches=batch.get("patches"),
                                     frames=batch.get("frames"))

        return prefill_fn

    def decode_fn(params, cache, token):
        return model_lib.decode_step(params, cfg, cache, token)

    return decode_fn


def step_shardings(cfg: ModelConfig, shape: InputShape, policy, args):
    """The specs of the step's arguments ``args`` (``input_specs``'
    stand-ins) under ``policy``, as ``policy.param_shardings`` & co. give
    them; ``policy.distribute`` lays a tree out by them, each spec as its
    ``policy.placements``.  A decode cache's ``pos`` and ``slot_pos`` are
    replicated."""
    if shape.kind == "train":
        params, opt_state, batch = args
        return (policy.param_shardings(params),
                policy.opt_shardings(opt_state),
                policy.batch_shardings(batch))
    if shape.kind == "prefill":
        params, batch = args
        return (policy.param_shardings(params),
                policy.batch_shardings(batch))
    params, cache, token = args
    return (policy.param_shardings(params),
            {"layers": policy.cache_shardings(cache["layers"]),
             "pos": (), "slot_pos": (None,)},
            policy.spec(tuple(token.shape), ("batch", None)))
