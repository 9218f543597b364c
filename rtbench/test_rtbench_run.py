"""A run without the card's look: the control fails where the program
passes, and a run with the timed path broken comes out not correct.

Small shapes on the CPU (``rtbench_smoke``); the engine row, the traffic
and the check are the cells' own, cut to 8 slots.  The first three faults
are planted in the program's decode window, which every served token after
the first comes from, the last in its MoE router:

  * a step that returns its state unchanged (the window hands back its
    input tokens and leaves the cache where it was);
  * half of the batch left out (each odd slot gets the tokens of the
    even slot before it: slots fill from the lowest, so the fault shows
    whenever two requests run at once, where a second half of the slots
    is reached only at the run's peak);
  * a token altered where it is produced (each window token plus one);
  * the top expert left out (each token's highest-weighted choice gets
    weight 0).

The router fault matches an outcome the check admits for a capacity drop
at every position; the share of positions that need one fails it.  A
router that leaves out only its lowest-weighted choices moves the logits
about as often as bf16 rounding does in sound runs and is not caught
(the readings are in PERF.md).

The exchange between chips is not a fault these one-card cells can have.
"""

import importlib
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))

import harness  # noqa: E402
import rtbench_smoke  # noqa: E402

SEED = 2**31 + 3


@pytest.fixture(scope="module")
def device():
    return torch.device("cpu")


def _cell(name, limit):
    cell = rtbench_smoke.small_cell(harness.load_cell(name))
    cell.config = dict(cell.config, check={"max_logit_gap": limit})
    return cell


@pytest.mark.parametrize("name", ["sc2-3b.chat-rt", "kimi-k2-2l.chat-sat"])
def test_control_reads_far_above_the_program(name, device):
    """The cells' limits are set at their own widths; at these the
    control's reading still stands three times the program's."""
    cell = _cell(name, None)
    model = rtbench_smoke.BY_FAMILY[cell.config["model"]["family"]]
    su = harness.setup(cell, SEED, device, model=model)
    win = harness.run_window(
        su, lambda: harness.requests_for(su, cell.rate, 0.75, SEED), False)
    prog, _ = harness.run_checks(su, win, SEED)
    ctrl, _ = harness.run_checks(su, win, SEED, quant="fp8")
    assert all(prog[k]["value"] == 0 for k in ("unfinished", "wrong_length",
                                                 "bad_token_ids"))
    p, c = prog["max_logit_gap"]["value"], ctrl["max_logit_gap"]["value"]
    assert c > 3 * p, (p, c)


def _unchanged(real):
    def window(params, cfg, cache, token, tables, *, num_steps,
               use_kernels):
        return token.expand(token.shape[0], num_steps).clone()
    return window


def _half(real):
    def window(*a, **kw):
        out = real(*a, **kw).clone()
        out[1::2] = out[0::2][:out.shape[0] // 2]
        return out
    return window


def _altered(real):
    def window(params, cfg, *a, **kw):
        return (real(params, cfg, *a, **kw) + 1) % cfg.vocab_size
    return window


def _drop_top(real):
    def route(params, xt, cfg):
        logits, probs, top_p, top_e = real(params, xt, cfg)
        top_p = top_p.clone()
        top_p[:, 0] = 0.0
        return logits, probs, top_p, top_e
    return route


FAULTS = {"state_unchanged": ("model", "decode_steps_paged", _unchanged),
          "half_batch": ("model", "decode_steps_paged", _half),
          "token_altered": ("model", "decode_steps_paged", _altered),
          "drop_top": ("moe", "route", _drop_top)}
# the router fault is judged on ``router_cell`` by the share of positions
# that need a drop, the others on ``moe_cell`` by the gap
ROUTER_FAULTS = ("drop_top",)


@pytest.fixture(scope="module")
def moe_cell(device):
    cell = harness.load_cell("kimi-k2-2l.chat-sat")
    return _cell("kimi-k2-2l.chat-sat",
                 cell.config["check"]["max_logit_gap"])


@pytest.fixture(scope="module")
def router_cell(device):
    """The MoE cell at the small shapes with its own limits, its
    products' weights at 0.08 in place of 0.02.  At 0.02 the experts move
    the small model's logits by thousandths and no fault of the router
    shows; at 0.08 they move them by tenths, as kimi-k2's do at its
    width, while the routing still spreads over the 8 experts.  Readings
    at these shapes, three seeds: sound runs a gap of 0.002-0.012 and a
    share of 0 over the drop gap 0.1; the top expert left out a share of
    0.087-0.128."""
    cell = harness.load_cell("kimi-k2-2l.chat-sat")
    cell = rtbench_smoke.small_cell(cell)
    cell.config = dict(cell.config, init={"std": 0.08})
    return cell


def test_sound_router_is_correct(router_cell, device):
    out = harness.run(router_cell, SEED, 0.75, False, device,
                      time.perf_counter(), model=rtbench_smoke.MOE,
                      say=lambda _: None)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_window_is_not_correct(fault, request, device, monkeypatch):
    cell = request.getfixturevalue(
        "router_cell" if fault in ROUTER_FAULTS else "moe_cell")
    module, name, wrap = FAULTS[fault]
    mod = importlib.import_module(f"repro_torch.models.{module}")
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    out = harness.run(cell, SEED, 0.75, False, device, time.perf_counter(),
                      model=rtbench_smoke.MOE, say=lambda _: None)
    assert out["correct"] is False
    failing = ("nonpad_drop_share" if fault in ROUTER_FAULTS
               else "max_logit_gap")
    assert out["checks"][failing]["value"] > out["checks"][failing]["limit"]
