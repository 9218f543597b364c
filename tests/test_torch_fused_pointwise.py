"""PyTorch port: the paged model path's fused pointwise kernels, on the CPU.

The CUDA kernels of ``kernels.rope_kv`` (RoPE + K/V page write) and
``kernels.rms_norm.add_rms_norm`` (residual add + RMSNorm) run only on the
card (``tests/test_torch_cuda.py`` holds them to the plain chains there).
Here, at starcoder2-3b's and kimi-k2's widths:

  * the cos/sin table the kernels read, rotated as they rotate
    (``ref.rope_by_table``), is ``layers.apply_rope`` bit for bit;
  * the wrappers' plain versions are the chains they replace, bit for bit;
  * a CPU tensor takes the plain versions (no launch), under autograd
    too, and another device than the CPU or the card raises.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rms_norm as trn  # noqa: E402
from repro_torch.kernels import rope_kv as trope  # noqa: E402
from repro_torch.kvcache import paged as paged_lib  # noqa: E402
from repro_torch.models import layers  # noqa: E402

#: (d_model, head dim): starcoder2-3b (24/2 heads) and kimi-k2 (64/8)
WIDTHS = [(3072, 128), (7168, 112)]
B, H, KV, BS, NB, THETA = 4, 4, 2, 16, 4, 1e5


def _rnd(g, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("D,hd", WIDTHS)
def test_rope_table_rotation_is_apply_rope(D, hd):
    """Decode rows (B, 1, H, hd) at their own positions and a packed
    stream (1, S, H, hd): the table's rotation equals ``apply_rope``'s,
    and the decode wrapper's plain version is ``apply_rope`` +
    ``scatter_token`` + ``contiguous``."""
    g = torch.Generator().manual_seed(D)
    table = layers.rope_table(hd, THETA, NB * BS, "cpu")
    assert table.dtype == torch.float32 and table.shape == (NB * BS, hd)
    pos = torch.tensor([0, BS - 1, BS, NB * BS - 1], dtype=torch.int32)
    q = _rnd(g, B, 1, H, hd)
    assert torch.equal(ref.rope_by_table(q, pos[:, None], table),
                       layers.apply_rope(q, pos[:, None], THETA))
    packed = _rnd(g, 1, 24, KV, hd)
    positions = torch.randint(0, NB * BS, (24,), generator=g)
    assert torch.equal(ref.rope_by_table(packed, positions[None], table),
                       layers.apply_rope(packed, positions[None], THETA))
    k, v = _rnd(g, B, 1, KV, hd), _rnd(g, B, 1, KV, hd)
    tables = torch.randperm(B * NB, generator=g).view(B, NB).to(torch.int32)
    pages = [torch.zeros((B * NB, BS, KV, hd), dtype=torch.bfloat16)
             for _ in range(4)]
    with torch.no_grad():
        got = trope.rope_kv_decode(q, k, v, pos, tables, pages[0], pages[1],
                                   theta=THETA)
    kr = layers.apply_rope(k, pos[:, None], THETA)
    paged_lib.scatter_token(pages[2], kr[:, 0], tables, pos)
    paged_lib.scatter_token(pages[3], v[:, 0], tables, pos)
    assert torch.equal(got, layers.apply_rope(q, pos[:, None], THETA)[:, 0])
    assert got.is_contiguous()
    assert torch.equal(pages[0], pages[2]) and torch.equal(pages[1], pages[3])


@pytest.mark.parametrize("D,hd", WIDTHS)
def test_add_rms_norm_is_add_then_norm(D, hd):
    """The add-and-norm wrapper's plain version: ``x + y``, then
    ``rms_norm_ref`` of that sum, bit for bit, in bf16 and float32; and
    the packed RoPE wrapper's: ``apply_rope``, then the rows asked for."""
    g = torch.Generator().manual_seed(D + 1)
    for dtype in (torch.bfloat16, torch.float32):
        x, y = _rnd(g, B, 1, D, dtype=dtype), _rnd(g, B, 1, D, dtype=dtype)
        w = _rnd(g, D) * 0.1
        s, out = trn.add_rms_norm(x, y, w, 1e-6)
        assert torch.equal(s, x + y)
        assert torch.equal(out, ref.rms_norm_ref(x + y, w, 1e-6))
    q, k, v = _rnd(g, 12, H, hd), _rnd(g, 12, KV, hd), _rnd(g, 12, KV, hd)
    positions = torch.arange(5, 17, dtype=torch.int32)
    rows = torch.tensor([0, 3, 3, 11, 11])
    gq, gk, gv = trope.rope_kv_packed(q, k, v, positions, rows, theta=THETA)
    assert torch.equal(gq, layers.apply_rope(q[None], positions[None],
                                             THETA)[0][rows])
    assert torch.equal(gk, layers.apply_rope(k[None], positions[None],
                                             THETA)[0][rows])
    assert torch.equal(gv, v[rows])


@pytest.mark.parametrize("D,hd", WIDTHS)
def test_cpu_tensors_take_the_plain_path(D, hd):
    """No launch for a CPU tensor, under autograd too (a gradient flows
    through the plain chain); another device than the CPU or the card
    raises."""
    g = torch.Generator().manual_seed(D + 2)
    x, y, w = _rnd(g, B, 1, D), _rnd(g, B, 1, D), _rnd(g, D) * 0.1
    q, k = _rnd(g, 6, H, hd), _rnd(g, 6, KV, hd)
    positions = torch.arange(6, dtype=torch.int32)
    before = (trn.launches, trope.launches)
    with torch.no_grad():
        trn.add_rms_norm(x, y, w)
        trope.rope_kv_packed(q, k, None, positions, theta=THETA)
    xg = x.float().requires_grad_()
    s, out = trn.add_rms_norm(xg, y.float(), w)
    qg = q.float().requires_grad_()
    rq = trope.rope_kv_packed(qg, k.float(), None, positions,
                              theta=THETA)[0]
    (out.sum() + rq.sum()).backward()
    assert xg.grad is not None and qg.grad is not None
    assert (trn.launches, trope.launches) == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trn.add_rms_norm(x.to("meta"), y.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trope.rope_kv_packed(q.to("meta"), k.to("meta"), None,
                             positions.to("meta"), theta=THETA)
