"""The frozen reference against the port's plain path, the weights'
layout against the port's, the tokenizer against the engine's."""

import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))

import check  # noqa: E402
import harness  # noqa: E402
import rtbench_smoke  # noqa: E402
import weights  # noqa: E402

REF = check.load_reference("decoder")


@pytest.fixture
def device():
    """The CPU: these tests hold the benchmark's own arithmetic, which
    the card's runs use as they are."""
    return torch.device("cpu")


def _tree(t):
    if isinstance(t, torch.Tensor):
        return (tuple(t.shape), t.dtype)
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return [_tree(v) for v in t]


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_weights_have_the_ports_layout(family, device):
    from repro_torch.models import model as model_lib
    model = rtbench_smoke.BY_FAMILY[family]
    cfg = harness.model_config(model, "t")
    ours = weights.make(model, 5, device)
    port = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                 device)
    assert _tree(ours) == _tree(port)
    again = weights.make(model, 5, device)
    assert torch.equal(ours["layers"][0]["attn"]["wq"],
                       again["layers"][0]["attn"]["wq"])
    other = weights.make(model, 6, device)
    assert not torch.equal(ours["embed"]["embedding"],
                           other["embed"]["embedding"])


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_reference_agrees_with_the_ports_plain_path(family, device):
    """float32 weights, prompts without padding (so no expert reaches
    its capacity): every position's logits within 1e-4 of the port's
    full-sequence forward."""
    from repro_torch.models import layers, transformer
    model = dict(rtbench_smoke.BY_FAMILY[family], param_dtype="float32")
    cfg = harness.model_config(model, "t")
    w = weights.make(model, 9, device)
    tok = torch.randint(2, model["vocab_size"], (3, 11),
                        generator=torch.Generator().manual_seed(1))
    pos = torch.arange(tok.shape[1])
    with torch.no_grad():
        x = layers.embed(w["embed"], tok, cfg)
        x, aux = transformer.apply_stack(w["layers"], x, {"positions": pos},
                                         cfg, None, "train")
        port = layers.logits(w["embed"], layers.rms_norm(
            x, w["final_ln"], cfg.norm_eps), cfg)[..., :model["vocab_size"]]
    assert float(aux["moe_drop_frac"]) == 0.0
    fw = REF.forward(w, model, tok)
    rows = torch.arange(tok.numel())
    best, mine, arg = REF.logit_stats(w, model, fw.hidden()[rows],
                                      port.argmax(-1).reshape(-1))
    port = port.reshape(-1, model["vocab_size"]).float()
    assert torch.allclose(best, port.max(-1).values, atol=1e-4)
    assert torch.equal(arg, port.argmax(-1))
    assert torch.allclose(mine, best, atol=1e-6)


def test_tokenizer_is_the_engines():
    from repro_torch.serving.engine import tokenize_padded
    for text in ["how do cats and dogs differ in cost, and diet?",
                 "", "Please pass the SALT.", "x " * 40]:
        for V in (2048, 49152, 163840):
            ours = check.padded_prompt(text, V, 32)
            assert ours == tokenize_padded(text, V, 32).tolist()


def test_control_rounds_to_float8():
    t = torch.tensor([[1.0, 0.3, -2.0], [1e-3, 2e-3, 3e-3]])
    q = REF._f8(t, -1)
    assert torch.equal(q[0, 2], torch.tensor(-2.0))
    assert not torch.equal(q, t)
    assert torch.allclose(q, t, rtol=0.07)
