"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed, with the longest one in it and
with offloaded ones where there are any, is run through the plain
reference (``references/<name>.py``) once: each request's prompt, hash
tokenized and left padded to the bucket as the engine does, followed by
the tokens it was served.  At every served position the number read is
the gap by which the served token's logit lies below the reference's
largest logit there.  The run compares the widest gap with the
configuration's limit (``check.max_logit_gap``), beside exact counts:
requests not completed, outputs of another length than asked (EOS is
disabled, so each output has its requested length), token ids outside the
vocabulary.

Capacity drops (MoE configurations).  The program drops a (token, expert)
choice past an expert's capacity, and whether a choice fits depends on
every other token of that dispatch: the fused prefill of up to 16 prompts,
the 128 rows of a decode step, the bulk lane's batch.  The reference sees
one request at a time and cannot know them.  So at each served position
it admits the outcomes a capacity can give that position and reads the
smallest gap among them (``_keeps``): every choice kept; any one or two
choices dropped; every choice of an expert the prompt's left padding
chose dropped, alone or with one more.  The padding positions of a
bucket hold one token and route alike, so the experts they choose
overflow first, in a fused prefill and, through the decode steps' idle
rows, which hold the padding token too, in a decode step; a token loses
its choices of them whenever enough of those rows precede it in the
dispatch.  The gap with every choice kept is printed beside it.

A drop of another expert's choice is rare in a sound run, and a program
that routed fewer than its top k, or dropped choices it should keep,
would match a one- or two-drop outcome at every position.  So a second
number limits how often the drops are needed: ``nonpad_drop_share``, the
share of the served positions whose gap stays above the configuration's
``drop_gap`` under both outcomes that drop no choice but the padding
experts' (all kept; the padding experts' dropped).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def hash_tokenize(text: str, vocab_size: int, max_len: int) -> List[int]:
    """The engine's toy tokenizer, worked out again: each whitespace word
    of the lower-cased text, FNV-1a over its UTF-8 bytes, mapped to
    2..V-1; the first ``max_len`` words; [2] for an empty text."""
    toks = []
    for w in text.lower().split()[:max_len]:
        h = 2166136261
        for c in w.encode():
            h = ((h ^ c) * 16777619) & 0xFFFFFFFF
        toks.append(2 + (h % (vocab_size - 2)))
    return toks or [2]


def padded_prompt(text: str, vocab_size: int, bucket: int) -> List[int]:
    seq = hash_tokenize(text, vocab_size, bucket)
    return [0] * (bucket - len(seq)) + seq


def load_reference(name: str):
    """``references/<name>.py``, loaded once."""
    key = f"rtbench_ref_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, HERE / "references" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def sample(done: List[dict], seed: int, tokens: int) -> List[dict]:
    """Finished requests to judge: up to two offloaded ones, the longest
    (first by arrival among equals), then others in an order drawn from
    the seed, until the served tokens reach ``tokens``."""
    rng = np.random.default_rng([seed, 7])
    order = [done[i] for i in rng.permutation(len(done))]
    bulk = [r for r in order if r["lane"] == "cpu"][:2]
    longest = max(done, key=lambda r: (len(r["out_tokens"]),
                                       -r["arrival"]))
    picked, seen = [], set()
    for r in bulk + [longest] + order:
        if id(r) in seen:
            continue
        if picked and sum(len(p["out_tokens"]) for p in picked) >= tokens:
            break
        picked.append(r)
        seen.add(id(r))
    return picked


def _rows(batch: List[dict], model: dict, bucket: int, device):
    """The padded token batch and, per served token, its row in the
    flattened batch, its id, and (its sequence's first row, the
    sequence's padding positions)."""
    V = model["vocab_size"]
    seqs = [padded_prompt(r["text"], V, bucket) + list(r["out_tokens"][:-1])
            for r in batch]
    L = max(len(s) for s in seqs)
    tok = torch.zeros(len(seqs), L, dtype=torch.long)
    rows, served, npad = [], [], []
    for b, (r, s) in enumerate(zip(batch, seqs)):
        tok[b, :len(s)] = torch.tensor(s)
        n_pad = bucket - len(hash_tokenize(r["text"], V, bucket))
        for j, t in enumerate(r["out_tokens"]):
            rows.append(b * L + bucket - 1 + j)
            served.append(int(t))
            npad.append((b * L, n_pad))
    dev = torch.device(device)
    return (tok.to(dev), torch.tensor(rows, device=dev),
            torch.tensor(served, device=dev), npad)


def _keeps(fw, rows, npad, K: int):
    """The capacity outcomes admitted at each served row, as masks of its
    k expert choices kept, (n, N, k): all kept; the choices of the
    prompt's padding experts dropped (these two first); each one dropped;
    each two dropped; the padding experts' dropped with each other one."""
    e = fw.experts[rows]                                  # (N, k)
    N = rows.shape[0]
    pad = torch.zeros(N, K, dtype=torch.bool, device=e.device)
    experts_of = {}
    for i, (base, n_pad) in enumerate(npad):
        if n_pad == 0:
            continue
        if base not in experts_of:
            experts_of[base] = fw.experts[base:base + n_pad].reshape(-1)
        pad[i] = torch.isin(e[i], experts_of[base])
    one = ~torch.eye(K, dtype=torch.bool, device=e.device)
    two = torch.stack([one[a] & one[b] for a in range(K)
                       for b in range(a + 1, K)])
    drops = torch.cat([one, two])[:, None, :].expand(-1, N, K)
    return torch.cat([torch.ones_like(pad)[None], (~pad)[None], drops,
                      (~pad)[None] & one[:, None, :]])


#: outcomes of ``_keeps`` that drop no choice but the padding experts'
PAD_ONLY = 2


def gaps(ref, weights, model: dict, fw, rows, served, npad):
    """Per served token: (the gap compared: for a MoE configuration the
    least over the capacity outcomes admitted there; the gap with every
    choice kept; the least over the outcomes that drop only the padding
    experts' choices)."""
    if fw.parts is None:
        best, mine, _ = ref.logit_stats(weights, model, fw.hidden()[rows],
                                        served)
        return best - mine, best - mine, best - mine
    keeps = _keeps(fw, rows, npad, model["experts_per_token"])
    n_var, N = keeps.shape[0], rows.shape[0]
    hidden = (fw.base[rows][None] + (fw.parts[rows][None]
                                     * keeps[..., None]).sum(2))
    best, mine, _ = ref.logit_stats(weights, model,
                                    hidden.reshape(n_var * N, -1),
                                    served.repeat(n_var))
    g = (best - mine).reshape(n_var, N)
    return g.min(0).values, g[0], g[:PAD_ONLY].min(0).values


#: gaps at which the share of positions the padding outcomes leave above
#: them is printed, for setting ``drop_gap``
SHARE_GAPS = (0.01, 0.02, 0.05, 0.1, 0.2, 0.35)


def judge(weights, model: dict, reference: str, batch: List[dict],
          bucket: int, device, quant: Optional[str] = None,
          block: int = 16, drop_gap: Optional[float] = None) -> Dict:
    """The widest gap over the served tokens of ``batch``
    (``max_logit_gap``), in blocks of ``block`` requests, with the widest
    gap with every expert choice kept beside it; with ``drop_gap``, the
    share of served tokens whose gap under the padding-only outcomes
    exceeds it (``nonpad_drop_share``).  With ``quant`` (the control),
    the tokens judged are those the lower-precision reference puts first
    at each position of the same sequences, in place of the served ones.
    ``repeat_share``: the judged tokens equal to the token before them."""
    ref = load_reference(reference)
    widest = kept = 0.0
    n = repeats = 0
    pad_gaps = []
    for b0 in range(0, len(batch), block):
        part = batch[b0:b0 + block]
        tok, rows, served, npad = _rows(part, model, bucket, device)
        if quant is not None:
            low = ref.forward(weights, model, tok, quant=quant)
            _, _, served = ref.logit_stats(weights, model,
                                           low.hidden()[rows], served,
                                           quant=quant)
            del low
        fw = ref.forward(weights, model, tok)
        g, g_kept, g_pad = gaps(ref, weights, model, fw, rows, served, npad)
        widest = max(widest, float(g.max()))
        kept = max(kept, float(g_kept.max()))
        pad_gaps.append(g_pad.float().cpu())
        repeats += int((tok.reshape(-1)[rows] == served).sum())
        n += int(rows.shape[0])
        del fw
    pad_gaps = torch.cat(pad_gaps)
    out = {"max_logit_gap": widest, "max_logit_gap_all_kept": kept,
           "tokens_judged": n, "repeat_share": repeats / max(n, 1),
           "pad_only_share_over": {
               str(t): float((pad_gaps > t).float().mean())
               for t in SHARE_GAPS}}
    if drop_gap is not None:
        out["nonpad_drop_share"] = float((pad_gaps > drop_gap).float().mean())
    return out
