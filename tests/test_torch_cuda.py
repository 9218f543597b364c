"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Needs a CUDA card (and ``nvcc`` to build the kernels); every test carries
the ``cuda`` marker and skips with a reason elsewhere.  The file imports
only ``torch`` and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_decode_attention as tpfd  # noqa: E402
from repro_torch.kernels import ragged_chunked_prefill as trcp  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_paged_decode_kernel_matches_plain(cuda):
    B, H, KV, D, bs, nb = 4, 24, 2, 128, 16, 6
    N = B * nb + 1
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, H, D), generator=g, device=cuda).bfloat16()
    kp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    vp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    tab = torch.randperm(N - 1, generator=g, device=cuda)[:B * nb].view(
        B, nb).int()
    lens = torch.tensor([0, 1, 37, nb * bs], dtype=torch.int32, device=cuda)
    before = tpfd.launches
    out = tpfd.paged_flash_decode_attention(q, kp, vp, tab, lens)
    torch.cuda.synchronize()
    assert tpfd.launches == before + 1
    want = tpfd.paged_decode_attention_ref(q, kp, vp, tab, lens)
    # two bf16 ulps at |x| ~ 1 (float32 sums in another order)
    assert (out.float() - want.float()).abs().max() <= 2e-2
    assert out[0].abs().max() == 0


@pytest.mark.cuda
def test_cuda_ragged_prefill_kernel_matches_plain(cuda):
    C, T, H, KV, D, bs, nb = 3, 32, 24, 2, 128, 16, 8
    N = C * nb + 1
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((C, T, H, D), generator=g, device=cuda).bfloat16()
    kn = torch.randn((C, T, KV, D), generator=g, device=cuda).bfloat16()
    vn = torch.randn((C, T, KV, D), generator=g, device=cuda).bfloat16()
    kp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    vp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    tab = torch.arange(C * nb, device=cuda, dtype=torch.int32).view(C, nb)
    tab[2] = N - 1
    meta = torch.tensor([[0, 40, 32, 0], [1, 0, 7, 32], [3, 0, 0, 39]],
                        dtype=torch.int32, device=cuda)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = trcp.launches
    out = trcp.ragged_chunked_prefill(q, kn, vn, k1, v1, tab, meta)
    torch.cuda.synchronize()
    assert trcp.launches == before + 1
    want = trcp.ragged_chunked_prefill_ref(q, kn, vn, k2, v2, tab, meta)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert torch.equal(k1[N - 1], kp[N - 1])
    for c, ln in enumerate((32, 7)):
        assert (out[c, :ln].float() - want[c, :ln].float()).abs().max() \
            <= 2e-2


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(cuda):
    """No fallback: a dtype the kernel does not take raises on the card."""
    q = torch.zeros((2, 4, 32), device=cuda)
    pages = torch.zeros((6, 16, 2, 32), device=cuda)
    tab = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    lens = torch.ones((2,), dtype=torch.int32, device=cuda)
    before = tpfd.launches
    with pytest.raises(TypeError, match="bfloat16"):
        tpfd.paged_flash_decode_attention(q, pages, pages, tab, lens)
    assert tpfd.launches == before


@pytest.mark.cuda
def test_cuda_model_decode_goes_through_the_kernel(cuda):
    """One paged decode step of the smoke model launches the kernel once
    per layer with ``use_kernels=True`` and never with ``False``; the two
    paths' logits agree to bf16 rounding carried through two layers (bf16
    logits: a few ulps of the largest, 2^-8 relative each)."""
    from repro_torch import configs
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    cfg = configs.get_smoke_config("starcoder2-3b")
    params = model_lib.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tables = torch.arange(8, dtype=torch.int32, device=cuda).view(2, 4)
    token = torch.tensor([[5], [7]], dtype=torch.int32, device=cuda)
    logits = {}
    for use_kernels in (True, False):
        cache = transformer.init_paged_cache(cfg, 2, 9, 4, device=cuda)
        cache["pos"].fill_(3)
        before = tpfd.launches
        _, logits[use_kernels] = model_lib.decode_step_paged(
            params, cfg, cache, token, tables, use_kernels=use_kernels)
        torch.cuda.synchronize()
        launched = tpfd.launches - before
        assert launched == (cfg.num_layers if use_kernels else 0)
    scale = float(logits[False].abs().max())
    assert float((logits[True] - logits[False]).abs().max()) <= 0.05 * scale
