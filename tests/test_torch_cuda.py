"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from llm_inference_tpu_torch.ops.kernels import decode_attention as t_dec
from llm_inference_tpu_torch.ops.kernels import kv_write as t_kvw
from llm_inference_tpu_torch.ops.kernels import quant_matmul as t_qm
from llm_inference_tpu_torch.ops.quantization import QTensor

BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernels have "
                    "no CPU mode (their plain versions are tested against "
                    "JAX in test_torch_kernels.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(1, 4096), (4, 4096), (4, 11008),
                                 (32, 4096), (128, 4096)])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_cuda_matches_plain(cuda, M, K, prologue):
    # M = 4 at K = 11008 keeps 88 KB of rows in the GEMV's shared memory
    g = torch.Generator().manual_seed(M)
    N = 1024
    qt = QTensor(q=torch.randint(-128, 128, (2, N, K), generator=g,
                                 dtype=torch.int8),
                 scale=torch.rand((2, 1, N), generator=g) * 1e-3)
    x = torch.randn((M, K), generator=g).to(BF16)
    kw = {}
    if prologue:
        kw = dict(norm_gamma=(1 + 0.1 * torch.randn((K,), generator=g)
                              ).to(BF16),
                  residual=torch.randn((M, K), generator=g).to(BF16),
                  want_x_out=True)
    want = t_qm.quant_matmul(x, qt, 1, **kw)
    got = t_qm.quant_matmul(x.to(cuda), qt.to(cuda), 1,
                            **{k: (v.to(cuda) if torch.is_tensor(v) else v)
                               for k, v in kw.items()})
    torch.cuda.synchronize()
    if prologue:
        (want, want_x), (got, got_x) = want, got
        assert torch.equal(got_x.cpu(), want_x)
    # same products, float32 sums in another order: one bf16 step of the
    # largest output (at most 2^-7 of it)
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("G,window,softcap", [(1, 0, 0.0), (4, 64, 0.0),
                                              (2, 0, 30.0)])
def test_k2_cuda_matches_plain(cuda, G, window, softcap):
    g = torch.Generator().manual_seed(G)
    L, B, Hkv, S, D = 2, 4, 8, 512, 128
    q = torch.randn((B, 1, Hkv * G, D), generator=g).to(BF16)
    k = torch.randn((L, B, Hkv, S, D), generator=g).to(BF16)
    v = torch.randn((L, B, Hkv, S, D), generator=g).to(BF16)
    pos = torch.tensor([0, 100, 300, S - 1], dtype=torch.int32)
    want = t_dec.decode_attention(q, k, v, 1, pos, logit_softcap=softcap,
                                  window=window)
    got = t_dec.decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), 1,
                                 pos.to(cuda), logit_softcap=softcap,
                                 window=window)
    torch.cuda.synchronize()
    # bf16 outputs; p rounds to bf16 against another running max: a few
    # bf16 steps (2^-8 relative) of the largest output
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_k3_cuda_matches_plain(cuda):
    g = torch.Generator().manual_seed(0)
    L, B, Hkv, S, D = 2, 4, 8, 64, 128
    k = torch.randn((L, B, Hkv, S, D), generator=g).to(BF16)
    v = torch.randn((L, B, Hkv, S, D), generator=g).to(BF16)
    kn = torch.randn((B, Hkv, 1, D), generator=g).to(BF16)
    vn = torch.randn((B, Hkv, 1, D), generator=g).to(BF16)
    off = torch.tensor([0, 9, S - 1, S + 3], dtype=torch.int32)
    kc, vc = k.to(cuda), v.to(cuda)
    t_kvw.write_token(k, v, 1, kn, vn, off)
    t_kvw.write_token(kc, vc, 1, kn.to(cuda), vn.to(cuda), off.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(kc.cpu(), k) and torch.equal(vc.cpu(), v)


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take(cuda):
    qt = QTensor(q=torch.zeros((1, 128, 4096), dtype=torch.int8,
                               device=cuda),
                 scale=torch.ones((1, 1, 128), device=cuda))
    x = torch.zeros((129, 4096), dtype=BF16, device=cuda)
    with pytest.raises(NotImplementedError, match="K8"):
        t_qm.quant_matmul(x, qt, 0)
    with pytest.raises(ValueError, match="contiguous"):
        t_qm.quant_matmul(x[:1], QTensor(q=qt.q[:, :, ::2],
                                         scale=qt.scale), 0)
