"""Batched generation (port of ``repro.serving.generate``).

``generate`` is host-loop greedy decoding of a batch over the contiguous
ring cache, with early exit when every row is done: the engine's bulk
lane.  The reference's jitted executable factories have no counterpart:
PyTorch runs eagerly, so the engine calls ``model.prefill_chunks`` and
``model.decode_steps_paged`` directly, and keeps the reference's
shape-key bookkeeping (``exec_cache_hits``/``misses``) on the host.
"""

from __future__ import annotations

import torch

from ..models import model as model_lib

PAD_ID = 0


@torch.no_grad()
def generate(params, cfg, tokens: torch.Tensor, *, max_new_tokens: int,
             eos_id: int = 1, max_lens=None):
    """Greedy-decode the (B, S) batch ``tokens``.  Returns (tokens
    (B, T <= max_new_tokens) i32, lengths (B,) i32), both on the device.

    ``max_lens``: optional (B,) per-row output caps; a row stops
    contributing at its cap, but the batch steps until its LONGEST row
    finishes (the run-to-completion head-of-line effect)."""
    max_len = tokens.shape[1] + max_new_tokens + 8
    cache, last_logits = model_lib.prefill(params, cfg, tokens, max_len)
    B = tokens.shape[0]
    dev = tokens.device
    token = torch.argmax(last_logits, -1).to(torch.int32)[:, None]
    done = token[:, 0] == eos_id
    lengths = torch.ones((B,), dtype=torch.int32, device=dev)
    if max_lens is not None:
        max_lens = torch.as_tensor(max_lens, dtype=torch.int32, device=dev)
        done = done | (lengths >= max_lens)
    out = [token]
    for _ in range(max_new_tokens - 1):
        if bool(done.all()):
            break
        token, _ = model_lib.decode_step(params, cfg, cache, token)
        token = torch.where(done[:, None], PAD_ID, token)
        lengths = lengths + (~done).to(torch.int32)
        done = done | (token[:, 0] == eos_id)
        if max_lens is not None:
            done = done | (lengths >= max_lens)
        out.append(token)
    return torch.cat(out, dim=1), lengths
