"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from llm_inference_tpu_torch.ops.kernels import decode_attention as t_dec
from llm_inference_tpu_torch.ops.kernels import flash_attention as t_flash
from llm_inference_tpu_torch.ops.kernels import kv_write as t_kvw
from llm_inference_tpu_torch.ops.kernels import quant_matmul as t_qm
from llm_inference_tpu_torch.ops.quantization import QTensor, quantize_kv4

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
                                 (32, 4096), (128, 4096), (9, 4096),
                                 (16, 4096), (17, 4096), (64, 4096),
                                 (100, 4096), (8, 13312)])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_cuda_matches_plain(cuda, M, K, prologue):
    # M = 4 at K = 11008 keeps 88 KB of rows in the GEMV's shared memory;
    # M = 8 at K = 13312 (208 KB) and M > 8 take the MMA branch, whose row
    # tile (16, 32, 64 or 128) leaves rows past M to TMA zero fill
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
    # above 128 rows K8 takes the product; it needs N % 64 == 0
    qt = QTensor(q=torch.zeros((1, 32, 4096), dtype=torch.int8,
                               device=cuda),
                 scale=torch.ones((1, 1, 32), device=cuda))
    x = torch.zeros((129, 4096), dtype=BF16, device=cuda)
    with pytest.raises(ValueError, match="K8"):
        t_qm.quant_matmul(x, qt, 0)
    with pytest.raises(ValueError, match="contiguous"):
        t_qm.quant_matmul(x[:1], QTensor(q=qt.q[:, :, ::2],
                                         scale=qt.scale), 0)


def _int4_weight(g, L, N, K, gsize=128):
    """Random stacked int4 weight: random bytes (codes uniform in [-8, 7]),
    scales of the right order for a unit-variance output."""
    return QTensor(q=torch.randint(-128, 128, (L, N, K // 2), generator=g,
                                   dtype=torch.int8),
                   scale=torch.rand((L, N, K // gsize), generator=g)
                   * 0.02 / 7 + 1e-4, bits=4)


def _to(kw, dev):
    return {k: (v.to(dev) if torch.is_tensor(v) else v)
            for k, v in kw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(1, 4096), (4, 4096), (4, 11008),
                                 (8, 4096), (32, 4096), (128, 4096),
                                 (128, 11008), (9, 4096), (16, 4096),
                                 (17, 4096), (64, 4096), (100, 4096),
                                 (8, 11008)])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_int4_cuda_matches_plain(cuda, M, K, prologue):
    # M <= 8 (and M * K * 4 <= 200 KiB) runs the float32-row GEMV, the
    # rest the MMA path, whose rows enter as bf16 (M = 8 at K = 11008:
    # 344 KB of float32 rows, too many for the GEMV)
    g = torch.Generator().manual_seed(M + K)
    N = 1024
    qt = _int4_weight(g, 2, N, K)
    x = torch.randn((M, K), generator=g).to(BF16)
    kw = {}
    if prologue:
        kw = dict(norm_gamma=(1 + 0.1 * torch.randn((K,), generator=g)
                              ).to(BF16),
                  residual=torch.randn((M, K), generator=g).to(BF16),
                  want_x_out=True)
    want = t_qm.quant_matmul(x, qt, 1, **kw)
    got = t_qm.quant_matmul(x.to(cuda), qt.to(cuda), 1, **_to(kw, cuda))
    torch.cuda.synchronize()
    if prologue:
        (want, want_x), (got, got_x) = want, got
        assert torch.equal(got_x.cpu(), want_x)
    # float32 sums in another order (the GEMV), or rows rounded to bf16
    # (the MMA path, a 2^-9 relative error per input that averages out
    # over K): one bf16 step of the largest output (2^-7 of it)
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


# (K, N) of the int4 GEMV's decode shapes: LLaMA-2-7B wqkv and lm_head,
# one tp = 2 rank's wqkv and wo shards, and narrow N (2 or 3 columns a
# block; and fewer columns than SMs, so that blocks without columns write
# their slice of x_out alone)
_GEMV4_SHAPES = [(4096, 12288), (4096, 32000), (4096, 6144), (2048, 4096),
                 (4096, 320), (1024, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", _GEMV4_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_int4_decode_shapes_cuda_matches_plain(cuda, K, N, M, prologue):
    # the GEMV (csrc/qmm4_gemv.cu) at the decode shapes: one persistent
    # block an SM over an even cut of N (lm_head's 243 columns a block in
    # two batches), rows in shared memory, products on mma.sync
    g = torch.Generator().manual_seed(K + N + M)
    _k1_check(cuda, _int4_weight(g, 2, N, K), M, K, prologue,
              seed=K + N + M + prologue, mma=False)


@pytest.mark.cuda
@pytest.mark.parametrize("gsize", [128, 8])
@pytest.mark.parametrize("M", [1, 8])
def test_k1_gemv4_launches_repeat_bit_identical(cuda, gsize, M):
    # every sum in a fixed order (no float atomics, no split of K across
    # blocks): two launches on the same inputs give the same bits
    g = torch.Generator().manual_seed(70 + gsize + M)
    K, N = 4096, 12288
    qt = _int4_weight(g, 2, N, K, gsize).to(cuda)
    x = torch.randn((M, K), generator=g).to(BF16).to(cuda)
    res = torch.randn((M, K), generator=g).to(BF16).to(cuda)
    gamma = (1 + 0.1 * torch.randn((K,), generator=g)).to(BF16).to(cuda)
    y1, h1 = t_qm.quant_matmul(x, qt, 1, norm_gamma=gamma, residual=res,
                               want_x_out=True)
    y2, h2 = t_qm.quant_matmul(x, qt, 1, norm_gamma=gamma, residual=res,
                               want_x_out=True)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert torch.isfinite(y1.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8])
def test_k1_gemv4_dependent_launch_same_bits(cuda, M):
    # the GEMV is a dependent launch: every thread waits for the kernel
    # ahead before it touches global memory, so launched right behind the
    # kernels that write its rows it gives the bits it gives on rows
    # written before a synchronize
    g = torch.Generator().manual_seed(80 + M)
    K, N = 4096, 6144
    qt = _int4_weight(g, 2, N, K).to(cuda)
    x = torch.randn((M, K), generator=g).to(cuda)
    gamma = (1 + 0.1 * torch.randn((K,), generator=g)).to(BF16).to(cuda)
    rows = (x * 2).to(BF16)
    torch.cuda.synchronize()
    want = t_qm.quant_matmul(rows, qt, 1, norm_gamma=gamma)
    torch.cuda.synchronize()
    buf = torch.zeros((M, K), dtype=BF16, device=cuda)
    torch.cuda.synchronize()
    buf.copy_((x * 2).to(BF16))
    got = t_qm.quant_matmul(buf, qt, 1, norm_gamma=gamma)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [78, 132, 144])
@pytest.mark.parametrize("K,N", _GEMV4_SHAPES[:4] + [(11008, 4096)])
def test_k1_gemv4_plan_balances_the_card(cuda, K, N, sms):
    """The int4 GEMV's ring plan as the kernel computes it
    (qmm4_gemv_plan): the blocks' column ranges differ by at most one and
    cover N once; a block's batches hold its columns, each batch within
    the ring's 192 columns (128 for groups of 16 or 8); the rows and at
    least two slots fit the card's shared memory; one pass over the
    weights at M <= 8 rows."""
    import ctypes
    from llm_inference_tpu_torch.ops.kernels import _build
    out = (ctypes.c_int * 10)()
    for M in (1, 2, 4, 8):
        if M * K * 4 > t_qm._GEMV_MAX_SMEM:
            continue
        for gs in (128, 32, 16, 8):
            assert _build.lib().qmm4_gemv_plan(M, K, N, K // gs, sms,
                                               out) == 0
            R, slot, smem, passes, q, ub, ncp, rows, lo, hi = out
            assert smem <= 232448 and R >= 2 and passes == 1
            assert M * (K * 4 + 16) + R * slot <= smem
            cuts = [N * b // sms for b in range(sms + 1)]
            sizes = [b - a for a, b in zip(cuts, cuts[1:])]
            assert (min(sizes), max(sizes)) == (lo, hi) and sum(sizes) == N
            assert hi - lo <= 1
            # batches of sizes within one unit of each other: the last
            # holds at least ub - (batches - 1) columns
            batches = -(-hi // ub)
            assert 1 <= ub <= (192 if gs % 32 == 0 else 128)
            assert hi - (batches - 1) * ub >= ub - (batches - 1)
            assert ncp == -(-ub // 8) * 8 and rows >= ncp and q >= 1


def _k1_weight(g, bits, N, K, gsize=128):
    if bits == 4:
        return _int4_weight(g, 2, N, K, gsize)
    return QTensor(q=torch.randint(-128, 128, (2, N, K), generator=g,
                                   dtype=torch.int8),
                   scale=torch.rand((2, 1, N), generator=g) * 1e-3)


def _k1_check(cuda, qt, M, K, prologue, seed, mma=True):
    """K1 on the card against its plain version on the CPU at M rows of
    width K; the MMA branch (or the GEMV) counted once."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((M, K), generator=g).to(BF16)
    kw = {}
    if prologue:
        kw = dict(norm_gamma=(1 + 0.1 * torch.randn((K,), generator=g)
                              ).to(BF16),
                  residual=torch.randn((M, K), generator=g).to(BF16),
                  want_x_out=True)
    want = t_qm.quant_matmul(x, qt, 1, **kw)
    before = (t_qm.launches, t_qm.mma_launches)
    got = t_qm.quant_matmul(x.to(cuda), qt.to(cuda), 1, **_to(kw, cuda))
    torch.cuda.synchronize()
    assert (t_qm.launches, t_qm.mma_launches) == (before[0] + 1,
                                                  before[1] + mma)
    if prologue:
        (want, want_x), (got, got_x) = want, got
        assert torch.equal(got_x.cpu(), want_x)
    # as test_k1_cuda_matches_plain: one bf16 step of the largest output
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 12288), (11008, 4096),
                                 (11008, 12288)])
@pytest.mark.parametrize("M", [16, 64, 128])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_mma_7b_widths_cuda_matches_plain(cuda, bits, K, N, M, prologue):
    # the MMA branch's stream-K plans at LLaMA-2-7B widths: 32 or 96 tiles
    # of 128 weight rows over 64 or 172 k steps (int4: 32 or 86 groups),
    # tiles shared by two or three blocks, row tiles of 16, 64 and 128
    g = torch.Generator().manual_seed(K + N + bits)
    _k1_check(cuda, _k1_weight(g, bits, N, K), M, K, prologue,
              seed=M + K + N + bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,gsize", [(8, 0), (4, 128), (4, 64), (4, 32),
                                        (4, 8)])
@pytest.mark.parametrize("M", [9, 100])
def test_k1_mma_narrow_edge_cuda_matches_plain(cuda, bits, gsize, M):
    # N = 320: the last tile of 128 weight rows holds 64 (their codes
    # arrive as TMA zero fill or are not read, nothing past N is stored);
    # groups of 8 and 32 take the mma.sync kernel
    g = torch.Generator().manual_seed(300 + bits + gsize + M)
    K, N = 1024, 320
    _k1_check(cuda, _k1_weight(g, bits, N, K, gsize or 128), M, K, True,
              seed=M + gsize)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [16, 128])
def test_k1_prefill_launches_repeat_bit_identical(cuda, bits, M):
    # the tiles that blocks share are summed in block order (no float
    # atomics): two launches on the same inputs give the same bits, and
    # the tile counters are left at zero for the next
    g = torch.Generator().manual_seed(90 + bits + M)
    K, N = 11008, 4096
    qt = _k1_weight(g, bits, N, K).to(cuda)
    x = torch.randn((M, K), generator=g).to(BF16).to(cuda)
    gamma = (1 + 0.1 * torch.randn((K,), generator=g)).to(BF16).to(cuda)
    y1 = t_qm.quant_matmul(x, qt, 1, norm_gamma=gamma)
    y2 = t_qm.quant_matmul(x, qt, 1, norm_gamma=gamma)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.isfinite(y1.float()).all()
    assert not t_qm._mma_done[x.device].any()


@pytest.mark.cuda
def test_k1_mma_failed_launch_raises(cuda):
    import ctypes
    from llm_inference_tpu_torch.ops.kernels import _build
    lib = _build.lib()
    part = torch.empty(2 * 600 * 16 * 128, device=cuda)
    done = torch.zeros(8, dtype=torch.int32, device=cuda)
    # more rows than the row tile, a grid larger than the units of work
    # (8 tiles x 32 slots of two k steps), and units that do not cover K
    # are refused by the C entry point before any launch; the wrapper's
    # check raises
    for M, bm, grid, units in ((17, 16, 132, 32), (16, 16, 8 * 32 + 1, 32),
                               (16, 16, 132, 31)):
        plan = (ctypes.c_int64 * 13)(M, 4096, 1024, 1, 8, bm, grid,
                                     part.data_ptr(), done.data_ptr(), 1,
                                     units, 1, 8 * units)
        code = lib.qmm_mma_launch(*([None] * 8), ctypes.addressof(plan),
                                  1e-5, None)
        with pytest.raises(RuntimeError, match="quant_matmul"):
            _build.check(code, "quant_matmul")


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype", [BF16, torch.float32])
def test_k4_cuda_matches_plain_exactly(cuda, in_dtype):
    g = torch.Generator().manual_seed(4)
    L, B, Hkv, S, D = 2, 4, 8, 64, 128
    k = torch.randint(-128, 128, (L, B, Hkv, S, D), generator=g,
                      dtype=torch.int8)
    v = torch.randint(-128, 128, (L, B, Hkv, S, D), generator=g,
                      dtype=torch.int8)
    ks = torch.rand((L, B, S, Hkv), generator=g)
    vs = torch.rand((L, B, S, Hkv), generator=g)
    # the new rows as the model hands them over: head slices of a wider
    # [B, 1, 3 * Hkv, D] projection (strided, not contiguous)
    qkv = (torch.randn((B, 1, 3 * Hkv, D), generator=g) * 3).to(in_dtype)
    qkv[1, 0, Hkv + 2] = 0.0                       # an all-zero row
    kn = qkv[:, :, Hkv:2 * Hkv].transpose(1, 2)
    vn = qkv[:, :, 2 * Hkv:].transpose(1, 2)
    off = torch.tensor([0, 9, S - 1, S + 3], dtype=torch.int32)
    dev = [t.to(cuda) for t in (k, v, ks, vs)]
    dev_plain = [t.clone() for t in dev]
    t_kvw.quantize_write_token(k, v, ks, vs, 1, kn, vn, off)
    t_kvw.quantize_write_token(*dev, 1, kn.to(cuda), vn.to(cuda),
                               off.to(cuda))
    # the plain version on the card too: its divisions must be IEEE ones
    t_kvw.quantize_write_token_ref(*dev_plain, 1, kn.to(cuda), vn.to(cuda),
                                   off.to(cuda))
    torch.cuda.synchronize()
    for a, p, b in zip(dev, dev_plain, (k, v, ks, vs)):
        assert torch.equal(a.cpu(), b) and torch.equal(p.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("G,window,softcap", [(1, 0, 0.0), (4, 64, 0.0),
                                              (2, 0, 30.0)])
def test_k2_int8_cuda_matches_plain(cuda, G, window, softcap):
    g = torch.Generator().manual_seed(10 + G)
    L, B, Hkv, S, D = 2, 4, 8, 512, 128
    q = torch.randn((B, 1, Hkv * G, D), generator=g).to(BF16)
    k = torch.randint(-128, 128, (L, B, Hkv, S, D), generator=g,
                      dtype=torch.int8)
    v = torch.randint(-128, 128, (L, B, Hkv, S, D), generator=g,
                      dtype=torch.int8)
    ks = torch.rand((L, B, S, Hkv), generator=g) * 0.02
    vs = torch.rand((L, B, S, Hkv), generator=g) * 0.02
    pos = torch.tensor([0, 100, 300, S - 1], dtype=torch.int32)
    want = t_dec.decode_attention(q, k, v, 1, pos, logit_softcap=softcap,
                                  window=window, k_scale=ks, v_scale=vs)
    got = t_dec.decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), 1,
                                 pos.to(cuda), logit_softcap=softcap,
                                 window=window, k_scale=ks.to(cuda),
                                 v_scale=vs.to(cuda))
    torch.cuda.synchronize()
    # as the bf16 cache: p · v_scale rounds to bf16 against another
    # running max, a few bf16 steps of the largest output
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 4, 7, 8, 16, 32])
def test_k6_cuda_matches_plain(cuda, M):
    # LLaMA-2-7B widths, one layer; M = 16 and 32 take passes of 8 rows
    _k6_case(cuda, M, 128, 60 + M)


def _k6_case(cuda, M, gsize, seed):
    g = torch.Generator().manual_seed(seed)
    H, I = 4096, 11008
    wo = _int4_weight(g, 1, H, H, gsize)
    gu = _int4_weight(g, 1, 2 * I, H, gsize)
    dn = _int4_weight(g, 1, H, I, gsize)
    h = torch.randn((M, H), generator=g).to(BF16)
    attn = torch.randn((M, H), generator=g).to(BF16)
    gamma = (1 + 0.1 * torch.randn((H,), generator=g)).to(BF16)
    want_y, want_h2 = t_qm.layer_tail_fused(h, attn, wo, gu, dn, gamma,
                                            1e-5, 0)
    before = t_qm.tail_launches
    got_y, got_h2 = t_qm.layer_tail_fused(
        h.to(cuda), attn.to(cuda), wo.to(cuda), gu.to(cuda), dn.to(cuda),
        gamma.to(cuda), 1e-5, 0)
    torch.cuda.synchronize()
    assert t_qm.tail_launches == before + 1
    # float32 sums in another order through three products: one bf16
    # step of the largest output (h2 is h + wo_out rounded once)
    for got, want in ((got_y, want_y), (got_h2, want_h2)):
        err = (got.cpu().float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("gsize", [32, 128])
@pytest.mark.parametrize("M", [1, 8])
def test_k6_groups_cuda_matches_plain(cuda, gsize, M):
    # groups of 32 and of 128 codes: every 32-code chunk folds its
    # group's scale
    _k6_case(cuda, M, gsize, 500 + gsize + M)


def _tail_inputs(g, kind, M):
    """K6 (LLaMA-2-7B widths) or K7 (one tp = 2 shard) arguments on the
    card, one layer of random int4 g = 128 weights."""
    H, I = (4096, 11008) if kind == "K6" else (4096, 5504)
    gu, dn = _int4_weight(g, 1, 2 * I, H), _int4_weight(g, 1, H, I)
    x = torch.randn((M, H), generator=g).to(BF16)
    other = torch.randn((M, H), generator=g).to(BF16)
    gamma = (1 + 0.1 * torch.randn((H,), generator=g)).to(BF16)
    if kind == "K6":
        args = (x, other, _int4_weight(g, 1, H, H), gu, dn, gamma, 1e-5, 0)
        fn = t_qm.layer_tail_fused
    else:
        args = (x, other, gamma, 1e-5, gu, dn, 0)
        fn = t_qm.ffn_fused
    dev = torch.device("cuda")
    return fn, tuple(a.to(dev) if isinstance(a, (torch.Tensor, QTensor))
                     else a for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["K6", "K7"])
@pytest.mark.parametrize("M", [1, 8])
def test_tail_launches_repeat_bit_identical(cuda, kind, M):
    # every sum is taken in a fixed order (no float atomics): two launches
    # on the same inputs give the same bits
    fn, args = _tail_inputs(torch.Generator().manual_seed(70 + M), kind, M)
    y1, h1 = fn(*args)
    y2, h2 = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert torch.isfinite(y1.float()).all()


# (name, H, Ko, I, wo): K6 at LLaMA-2-7B width, K7 on one rank's shard at
# tp = 2, K6 at the widths of the CPU tests and of the small-group card
# tests
_TAIL_CASES = [("7b", 4096, 4096, 11008, 1), ("tp2", 4096, 4096, 5504, 0),
               ("tiny", 256, 256, 512, 1), ("small", 1024, 1024, 2816, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [78, 132, 144])
@pytest.mark.parametrize("case", _TAIL_CASES, ids=[c[0] for c in _TAIL_CASES])
def test_tail_plan_balances_the_card(cuda, case, sms):
    """K6/K7's ring plan as the kernel computes it (layer_tail_plan): every
    SM takes the same units of each phase to within one (a column, or a
    gate/up pair), at the LLaMA-2-7B and tp = 2 widths within one stage's
    bytes; the block's shared memory fits the card with at least two
    slots; at M <= 8 rows one pass over the weights (ceil(M / 8) above)."""
    import ctypes
    from llm_inference_tpu_torch.ops.kernels import _build
    name, H, Ko, I, wo = case
    out = (ctypes.c_int * 25)()
    for M in (1, 2, 4, 7, 8, 16, 32):
        for gs in (128, 32, 16, 8):
            assert _build.lib().layer_tail_plan(
                M, H, Ko, I, Ko // gs, H // gs, I // gs, sms, wo, out) == 0
            R, slot, smem, passes = out[:4]
            assert smem <= 232448 and R >= 2 and passes == -(-M // 8)
            # (units, K, 1 or 2 columns a unit) of wo, gate-up and down
            phases = [(H, Ko, 1), (I, H, 2), (H, I, 1)][1 - wo:]
            for (units, K, per), i in zip(phases, range(1 - wo, 3)):
                q, ub, cols, ncp, rows, lo, hi = out[4 + 7 * i:11 + 7 * i]
                assert hi - lo <= 1 and lo * sms <= units <= hi * sms
                assert 1 <= q <= 8 and 1 <= ub and cols == ub * per <= 192
                assert ncp == -(-ub // 8) * 8 * per and rows >= ncp
                # a unit's codes and scales against one stage's (the stage
                # is 256 q codes of every column of a batch)
                kt = min(256 * q, K)
                unit = per * (K // 2 + 4 * (K // gs))
                stage = cols * (kt // 2 + 4 * (kt // gs))
                if name in ("7b", "tp2"):
                    assert (hi - lo) * unit <= stage, (name, M, gs, i)


@pytest.mark.cuda
def test_k6_failed_launch_raises(cuda):
    from llm_inference_tpu_torch.ops.kernels import _build
    # M = 0 is refused by the C entry point; the wrapper's check raises
    code = _build.lib().layer_tail_launch(*([None] * 13), 0, 4096, 4096,
                                          11008, 32, 32, 86, 1e-5, None)
    with pytest.raises(RuntimeError, match="layer_tail"):
        _build.check(code, "layer_tail_fused")


# ------------------------------------------------------- K8 (M > 128)

@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(256, 4096, 1024), (300, 4096, 1024),
                                   (300, 11008, 512), (129, 4096, 384),
                                   (1024, 4096, 1024), (1024, 11008, 512)])
@pytest.mark.parametrize("prologue", [False, True])
def test_k8_cuda_matches_plain(cuda, bits, M, K, N, prologue):
    # the wgmma kernel's row tile is 256 (int8) or 128 (int4) rows: M = 129
    # and 300 end in a partial tile (TMA zero-fills the rows past M), 1024
    # fills 4 or 8 whole ones; N = 384: three bands of 128 weight rows;
    # K = 11008 (w_down): 172 k steps, 86 int4 groups
    g = torch.Generator().manual_seed(M + K + bits)
    if bits == 4:
        qt = _int4_weight(g, 2, N, K)
    else:
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
    before = t_qm.tiled_launches
    got = t_qm.quant_matmul(x.to(cuda), qt.to(cuda), 1, **_to(kw, cuda))
    torch.cuda.synchronize()
    assert t_qm.tiled_launches == before + 1
    if prologue:
        (want, want_x), (got, got_x) = want, got
        assert torch.equal(got_x.cpu(), want_x)
    # the same bf16 products, float32 sums in another order (and the
    # prologue's rsqrt may move a row by a bf16 rounding): one bf16 step
    # of the largest output
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


# ------------------------------------------------------ K9 (flash)

def _flash_cache(g, kind, L, B, Hkv, S, D):
    """k, v and (quantized) scales [L, B, S, Hkv] of random rows."""
    shape = (L, B, Hkv, S, D)
    if kind == "bf16":
        return (torch.randn(shape, generator=g).to(BF16),
                torch.randn(shape, generator=g).to(BF16), None, None)
    if kind == "int8":
        k = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
        v = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
    else:
        (k, _), (v, _) = (quantize_kv4(torch.randn(shape, generator=g))
                          for _ in range(2))
    ks = torch.rand((L, B, S, Hkv), generator=g) * 0.02 + 1e-3
    vs = torch.rand((L, B, S, Hkv), generator=g) * 0.02 + 1e-3
    return k, v, ks, vs


def _nan_past(k, v, ks, vs, b, first):
    """NaN in sequence b's slots from `first` on (bf16 rows; the scales of
    a quantized cache, whose codes cannot hold NaN), as a retired or never
    written slot may hold."""
    if ks is None:
        k[:, b, :, first:] = v[:, b, :, first:] = float("nan")
    else:
        ks[:, b, first:] = vs[:, b, first:] = float("nan")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("B,T,Hq,Hkv,S,D,starts,window,softcap,nan", [
    (1, 256, 8, 8, 512, 128, (0,), 0, 0.0, False),       # from scratch
    (2, 200, 8, 2, 512, 128, (0, 130), 0, 0.0, False),   # GQA, tail, history
    (1, 96, 4, 4, 512, 64, (300,), 100, 0.0, False),     # window
    (1, 128, 4, 2, 256, 128, (64,), 0, 30.0, False),     # softcap
    # T off the 128-row tile, a history offset off it, NaN past the frontier
    (1, 1000, 8, 8, 2048, 128, (37,), 0, 0.0, True),
    (2, 160, 8, 2, 512, 256, (0, 70), 0, 0.0, True),     # D = 256 with GQA
    (1, 2048, 32, 32, 2048, 128, (0,), 0, 0.0, False),   # LLaMA-2-7B chunk
])
def test_k9_cuda_matches_plain(cuda, kind, B, T, Hq, Hkv, S, D, starts,
                               window, softcap, nan):
    g = torch.Generator().manual_seed(T + S + len(kind))
    L = 2
    k, v, ks, vs = _flash_cache(g, kind, L, B, Hkv, S, D)
    if nan:
        for b, s in enumerate(starts):
            _nan_past(k, v, ks, vs, b, s + T)
    q = torch.randn((B, T, Hq, D), generator=g).to(BF16)
    pos = torch.stack([s + torch.arange(T) for s in starts]).to(torch.int32)
    kw = dict(logit_softcap=softcap, sliding_window=window)
    want = t_flash.flash_attention(q, k, v, 1, pos, k_scale=ks, v_scale=vs,
                                   **kw)
    assert torch.isfinite(want).all()
    dev = [None if t is None else t.to(cuda) for t in (k, v, ks, vs)]
    before = t_flash.launches
    got = t_flash.flash_attention(q.to(cuda), dev[0], dev[1], 1,
                                  pos.to(cuda), k_scale=dev[2],
                                  v_scale=dev[3], **kw)
    torch.cuda.synchronize()
    assert t_flash.launches == before + 1
    assert torch.isfinite(got).all()
    # bf16 output; the same blocks and rounding points (int4: p split into
    # two bf16 parts, 16 of its 24 bits), float32 sums in another order: a
    # few bf16 steps (2^-8 relative) of the largest output
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,N", [(300, 1088), (2048, 320), (129, 64)])
@pytest.mark.parametrize("prologue", [False, True])
def test_k8_last_band_of_64_rows_cuda_matches_plain(cuda, bits, M, N,
                                                    prologue):
    # N a multiple of 64 but not of 128 (phi3's lm_head 32064, gemma3's
    # tied head 262208): the last band of 128 weight rows holds 64, the
    # TMA fills the others with zeros and their columns are not stored
    g = torch.Generator().manual_seed(M + N + bits)
    K = 2560
    if bits == 4:
        qt = _int4_weight(g, 2, N, K)
    else:
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
    before = t_qm.tiled_launches
    got = t_qm.quant_matmul(x.to(cuda), qt.to(cuda), 1, **_to(kw, cuda))
    torch.cuda.synchronize()
    assert t_qm.tiled_launches == before + 1
    if prologue:
        (want, want_x), (got, got_x) = want, got
        assert torch.equal(got_x.cpu(), want_x)
    # as test_k8_cuda_matches_plain: one bf16 step of the largest output
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


# gemma2's attention: D = 256, G = 2, a 1024- or 4096-slot window, softcap
# 50; the query scale query_pre_attn_scalar^-0.5, here 0.1 (not D^-0.5)
_GEMMA_SCALE = 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("T,start,S,window,softcap", [
    (512, 1500, 2048, 1024, 50.0),      # the window starts mid-block
    (256, 0, 2048, 1024, 0.0),          # within the window from scratch
    (1024, 1024, 2048, 1000, 50.0)])
def test_k9_gemma_shapes_cuda_matches_plain(cuda, kind, T, start, S, window,
                                            softcap):
    g = torch.Generator().manual_seed(T + start + len(kind))
    Hq, Hkv, D = 8, 4, 256
    k, v, ks, vs = _flash_cache(g, kind, 2, 1, Hkv, S, D)
    q = torch.randn((1, T, Hq, D), generator=g).to(BF16)
    pos = (start + torch.arange(T, dtype=torch.int32))[None]
    kw = dict(scale=_GEMMA_SCALE, logit_softcap=softcap,
              sliding_window=window)
    want = t_flash.flash_attention(q, k, v, 1, pos, k_scale=ks, v_scale=vs,
                                   **kw)
    dev = [None if t is None else t.to(cuda) for t in (k, v, ks, vs)]
    got = t_flash.flash_attention(q.to(cuda), dev[0], dev[1], 1,
                                  pos.to(cuda), k_scale=dev[2],
                                  v_scale=dev[3], **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # as test_k9_cuda_matches_plain: a few bf16 steps of the largest output
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_gemma_shapes_cuda_matches_plain(cuda, kind, paged):
    """K2/K5 (dense) and K10a/K10b (pages) at D = 256, G = 2, a 1024-slot
    window whose start falls inside a tile, softcap 50 and a query scale
    of 0.1; positions before, at and past the window over 4096 slots."""
    from llm_inference_tpu_torch.ops.kernels import paged_attention as t_pa
    g = torch.Generator().manual_seed(7 + paged + len(kind))
    L, B, Hkv, G, D, S, ps = 2, 4, 4, 2, 256, 4096, 128
    pos = torch.tensor([200, 1023, 2500, S - 1], dtype=torch.int32)
    q = torch.randn((B, 1, Hkv * G, D), generator=g).to(BF16)
    kw = dict(scale=_GEMMA_SCALE, logit_softcap=50.0, window=1024)
    if paged:
        NB = S // ps
        live = [int(p) // ps + 1 for p in pos]
        P = sum(live) + 3
        k, v, ks, vs = _paged_pool(g, kind, L, P, Hkv, ps, D)
        pt = _scattered_table(g, B, NB, P, live)
        want = t_pa.paged_attention(q, k, v, pt, 1, pos, k_scale=ks,
                                    v_scale=vs, **kw)
        dev = [None if t is None else t.to(cuda) for t in (k, v, ks, vs)]
        got = t_pa.paged_attention(q.to(cuda), dev[0], dev[1], pt.to(cuda),
                                   1, pos.to(cuda), k_scale=dev[2],
                                   v_scale=dev[3], **kw)
    else:
        k, v, ks, vs = _flash_cache(g, kind, L, B, Hkv, S, D)
        want = t_dec.decode_attention(q, k, v, 1, pos, k_scale=ks,
                                      v_scale=vs, **kw)
        dev = [None if t is None else t.to(cuda) for t in (k, v, ks, vs)]
        got = t_dec.decode_attention(q.to(cuda), dev[0], dev[1], 1,
                                     pos.to(cuda), k_scale=dev[2],
                                     v_scale=dev[3], **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # as K2's and K10's cases: a few bf16 steps of the largest output
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("G,window,S", [(1, 0, 4096), (4, 700, 2048)])
def test_k2_split_cuda_matches_plain(cuda, kind, G, window, S):
    """Caches of 1024 slots or more split each head's slots over several
    blocks whose softmax states the last block merges; a position in the
    first share leaves the other shares empty."""
    g = torch.Generator().manual_seed(30 + G + S)
    L, B, Hkv, D = 2, 4, 8, 128
    k, v, ks, vs = _flash_cache(g, kind, L, B, Hkv, S, D)
    q = torch.randn((B, 1, Hkv * G, D), generator=g).to(BF16)
    pos = torch.tensor([3, 700, S // 2 + 5, S - 1], dtype=torch.int32)
    kw = dict(window=window, k_scale=ks, v_scale=vs)
    want = t_dec.decode_attention(q, k, v, 1, pos, **kw)
    dev = {n: (None if t is None else t.to(cuda))
           for n, t in (("k_scale", ks), ("v_scale", vs))}
    for _ in range(2):              # the merge counters are reset for reuse
        got = t_dec.decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), 1,
                                     pos.to(cuda), window=window, **dev)
        torch.cuda.synchronize()
        tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
        assert (got.cpu().float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_decode_tile_slots_cuda(cuda):
    """The split rule takes the kernel's own tile (decode_attn_tile_slots):
    32 or 64 slots of at most 16 KB of rows for every head size and cache
    kind, 0 for a head size the kernel lacks, and on this card no split of
    a cache shorter than two tiles."""
    dev = torch.device(cuda.type, torch.cuda.current_device())
    for D in (64, 128, 256):
        for kind, row in enumerate((2 * D, D, D // 2)):
            tile = t_dec.tile_slots(D, kind)
            assert tile in (32, 64) and tile * row <= 16384
            for B, S in ((1, 512), (1, 4096), (8, 512), (4, 16384)):
                n = t_dec.split_buffers(dev, B, 32, 1, S, D, kind)[0]
                assert n == 1 or S // n >= 2 * tile
    from llm_inference_tpu_torch.ops.kernels import _build
    assert _build.lib().decode_attn_tile_slots(96, 0) == 0


def _on_card_of(monkeypatch, cuda, sms):
    """Run the split rule as on a card of `sms` SMs: 1 gives every head one
    block (its live slots cross tile edges), many give each head as many
    splits as the cache has tiles (short and empty shares)."""
    dev = torch.device(cuda.type, torch.cuda.current_device())
    monkeypatch.setitem(t_dec._sms, dev, sms)


def _nan_outside(k, v, ks, vs, b, lo, hi):
    """NaN in sequence b's slots outside [lo, hi] (bf16 rows; the scales of
    a quantized cache): stale rows a kernel must never read."""
    for sl in (slice(0, lo), slice(hi + 1, None)):
        if ks is None:
            k[:, b, :, sl] = v[:, b, :, sl] = float("nan")
        else:
            ks[:, b, sl] = vs[:, b, sl] = float("nan")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("B,Hkv,G,D,S,positions,window,softcap,sms", [
    (4, 2, 1, 128, 512, (63, 64, 65, 191), 0, 0.0, 1),     # tile edges
    (4, 2, 1, 128, 1024, (0, 5, 40, 1023), 0, 0.0, 1000),  # short, empty
    (2, 2, 8, 64, 256, (100, 255), 0, 0.0, 132),           # D = 64, G = 8
    (4, 2, 2, 256, 256, (31, 32, 33, 200), 0, 30.0, 1),    # D = 256 edges
    (2, 4, 4, 128, 512, (150, 300), 100, 0.0, 1),          # window mid-tile
    (2, 2, 4, 256, 1024, (0, 700), 0, 0.0, 1000),          # D = 256 splits
])
def test_decode_tiles_cuda_matches_plain(cuda, monkeypatch, kind, B, Hkv, G,
                                         D, S, positions, window, softcap,
                                         sms):
    """K2 (bf16, int8) and K5 (int4) at the edges of the tiled design: live
    slots ending on a tile edge and one slot either side, shares shorter
    than a tile and empty ones, D = 64 and 256, G = 8, a window starting
    mid-tile, NaN in every slot outside the window, and two launches in a
    row (the merge counters reset)."""
    _on_card_of(monkeypatch, cuda, sms)
    g = torch.Generator().manual_seed(S + D + G + sms)
    L = 2
    k, v, ks, vs = _flash_cache(g, kind, L, B, Hkv, S, D)
    for b, p in enumerate(positions):
        lo = max(0, p - window + 1) if window > 0 else 0
        _nan_outside(k, v, ks, vs, b, lo, p)
    q = torch.randn((B, 1, Hkv * G, D), generator=g).to(BF16)
    pos = torch.tensor(positions, dtype=torch.int32)
    kw = dict(logit_softcap=softcap, window=window)
    want = t_dec.decode_attention(q, k, v, 1, pos, k_scale=ks, v_scale=vs,
                                  **kw)
    assert torch.isfinite(want).all()
    dev = [None if t is None else t.to(cuda) for t in (k, v, ks, vs)]
    before = (t_dec.launches, t_dec.int4_launches)
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    for _ in range(2):
        got = t_dec.decode_attention(q.to(cuda), dev[0], dev[1], 1,
                                     pos.to(cuda), k_scale=dev[2],
                                     v_scale=dev[3], **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        # as test_k2_cuda_matches_plain: a few bf16 steps of the largest
        # output (p rounds against another running max)
        assert (got.cpu().float() - want.float()).abs().max().item() <= tol
    int4 = kind == "int4"
    assert (t_dec.launches, t_dec.int4_launches) == (
        before[0] + 2 * (not int4), before[1] + 2 * int4)


# --------------------------------------------- int4 cache (K5, writes)

@pytest.mark.cuda
@pytest.mark.parametrize("G,window,softcap,S", [(1, 0, 0.0, 4096),
                                                (4, 64, 0.0, 512),
                                                (2, 0, 30.0, 512)])
def test_k5_cuda_matches_plain(cuda, G, window, softcap, S):
    g = torch.Generator().manual_seed(20 + G)
    L, B, Hkv, D = 2, 4, 8, 128
    k, v, ks, vs = _flash_cache(g, "int4", L, B, Hkv, S, D)
    q = torch.randn((B, 1, Hkv * G, D), generator=g).to(BF16)
    pos = torch.tensor([0, 100, S // 2, S - 37], dtype=torch.int32)
    kw = dict(logit_softcap=softcap, window=window)
    want = t_dec.decode_attention(q, k, v, 1, pos, k_scale=ks, v_scale=vs,
                                  **kw)
    before = t_dec.int4_launches
    got = t_dec.decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), 1,
                                 pos.to(cuda), k_scale=ks.to(cuda),
                                 v_scale=vs.to(cuda), **kw)
    torch.cuda.synchronize()
    assert t_dec.int4_launches == before + 1
    # float32 p on both sides, float32 sums in another order, one bf16
    # rounding: a few bf16 steps of the largest output
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_int4_cache_decode_write_cuda_matches_plain(cuda):
    """K3 on the packed 64-byte rows of an int4 cache (D = 128) and the
    scale write, as update_cache_layer runs them: exact."""
    from llm_inference_tpu_torch.ops import kvcache
    g = torch.Generator().manual_seed(7)
    L, B, Hkv, S, D = 2, 4, 8, 64, 128
    caches = [kvcache.init_cache(L, B, Hkv, S, D, "int4", device=dev)
              for dev in ("cpu", cuda)]
    kn = torch.randn((B, 1, Hkv, D), generator=g).to(BF16)
    vn = torch.randn((B, 1, Hkv, D), generator=g).to(BF16)
    off = torch.tensor([0, 9, S - 1, S + 3], dtype=torch.int32)
    before = (t_kvw.launches, t_kvw.scale_launches)
    for c in caches:
        kvcache.update_cache_layer(c, 1, kn.to(c.k.device),
                                   vn.to(c.k.device), off.to(c.k.device))
    torch.cuda.synchronize()
    assert (t_kvw.launches, t_kvw.scale_launches) == (before[0] + 1,
                                                      before[1] + 1)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(caches[1], name).cpu(),
                           getattr(caches[0], name))
    assert caches[0].k[1].any()


@pytest.mark.cuda
def test_write_token_scales_cuda_matches_plain(cuda):
    g = torch.Generator().manual_seed(8)
    L, B, S, Hkv = 2, 4, 64, 32
    ks = torch.rand((L, B, S, Hkv), generator=g)
    vs = torch.rand((L, B, S, Hkv), generator=g)
    ksn = torch.rand((B, 1, Hkv), generator=g)
    vsn = torch.rand((B, 1, Hkv), generator=g)
    off = torch.tensor([0, 9, S - 1, S + 3], dtype=torch.int32)
    kd, vd = ks.to(cuda), vs.to(cuda)
    t_kvw.write_token_scales(ks, vs, 1, ksn, vsn, off)
    t_kvw.write_token_scales(kd, vd, 1, ksn.to(cuda), vsn.to(cuda),
                             off.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(kd.cpu(), ks) and torch.equal(vd.cpu(), vs)


# ------------------------------------ paged pools (K10a, K10b, K11)

def _paged_pool(g, kind, L, P, Hkv, ps, D):
    """Random pools [L, P, Hkv, ps, Dc] of `kind` with scales [L, P, ps,
    Hkv]; page 0 (the null page) holds NaN where the pool is float."""
    shape = (L, P, Hkv, ps, D)
    if kind == "bf16":
        k = torch.randn(shape, generator=g).to(BF16)
        v = torch.randn(shape, generator=g).to(BF16)
        k[:, 0] = v[:, 0] = float("nan")
        return k, v, None, None
    if kind == "int8":
        k = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
        v = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
    else:
        (k, _), (v, _) = (quantize_kv4(torch.randn(shape, generator=g))
                          for _ in range(2))
    ks = torch.rand((L, P, ps, Hkv), generator=g) * 0.02 + 1e-3
    vs = torch.rand((L, P, ps, Hkv), generator=g) * 0.02 + 1e-3
    ks[:, 0] = vs[:, 0] = float("nan")
    return k, v, ks, vs


def _scattered_table(g, B, NB, P, live_blocks):
    """[B, NB] int32: each row's first live_blocks[b] entries are distinct
    pages drawn from 1..P-1 in scattered order, the rest the null page."""
    perm = torch.randperm(P - 1, generator=g) + 1
    pt = torch.zeros((B, NB), dtype=torch.int32)
    o = 0
    for b, n in enumerate(live_blocks):
        pt[b, :n] = perm[o:o + n]
        o += n
    return pt


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("G,window,softcap,ps,NB", [
    (1, 0, 0.0, 128, 32),          # 4096 slots: the split over slots
    (4, 64, 0.0, 16, 8), (2, 0, 30.0, 128, 4)])
def test_k10_cuda_matches_plain(cuda, kind, G, window, softcap, ps, NB):
    """K10a (bf16, int8 pages) and K10b (int4 pages) over scattered pages,
    one row's position past its table (it clamps to the last slot) and
    NaN in the null page that unallocated entries point at."""
    from llm_inference_tpu_torch.ops.kernels import paged_attention as t_pa
    g = torch.Generator().manual_seed(40 + G + ps)
    L, B, Hkv, D = 2, 4, 8, 128
    S = NB * ps
    pos = torch.tensor([0, S // 3, S - 1, S + 40], dtype=torch.int32)
    live = [min(int(p) // ps + 1, NB) for p in pos]
    P = sum(live) + 3
    k, v, ks, vs = _paged_pool(g, kind, L, P, Hkv, ps, D)
    pt = _scattered_table(g, B, NB, P, live)
    q = torch.randn((B, 1, Hkv * G, D), generator=g).to(BF16)
    kw = dict(logit_softcap=softcap, window=window)
    want = t_pa.paged_attention(q, k, v, pt, 1, pos, k_scale=ks, v_scale=vs,
                                **kw)
    assert torch.isfinite(want).all()
    dev = [None if t is None else t.to(cuda) for t in (k, v, ks, vs)]
    before = (t_pa.launches, t_pa.int4_launches)
    for _ in range(2):             # the merge counters are reset for reuse
        got = t_pa.paged_attention(q.to(cuda), dev[0], dev[1], pt.to(cuda), 1,
                                   pos.to(cuda), k_scale=dev[2],
                                   v_scale=dev[3], **kw)
        torch.cuda.synchronize()
        # as K2/K5: a few bf16 steps (2^-8 relative) of the largest output
        tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
        assert (got.cpu().float() - want.float()).abs().max().item() <= tol
    int4 = kind == "int4"
    assert (t_pa.launches, t_pa.int4_launches) == (before[0] + 2 * (not int4),
                                                   before[1] + 2 * int4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("B,Hkv,G,D,ps,NB,positions,window,softcap,sms", [
    (4, 2, 1, 128, 16, 16, (63, 64, 65, 255), 0, 0.0, 1),   # tile edges
    (4, 2, 1, 128, 128, 8, (0, 5, 40, 1063), 0, 0.0, 1000),  # short, empty
    (2, 2, 8, 64, 8, 32, (100, 255), 0, 0.0, 132),          # D = 64, G = 8
    (2, 2, 2, 256, 32, 8, (150, 255), 100, 30.0, 1),        # D = 256, window
])
def test_k10_tiles_cuda_matches_plain(cuda, monkeypatch, kind, B, Hkv, G, D,
                                      ps, NB, positions, window, softcap,
                                      sms):
    """K10a/K10b at the edges of the tiled design: tiles that span several
    pages, live slots ending on a tile edge and either side of it, short
    and empty shares, D = 64 and 256, G = 8, a window starting mid-tile, a
    position past the table, NaN in the null page, two launches in a
    row."""
    from llm_inference_tpu_torch.ops.kernels import paged_attention as t_pa
    _on_card_of(monkeypatch, cuda, sms)
    g = torch.Generator().manual_seed(NB * ps + D + G + sms)
    L = 2
    live = [min(p // ps + 1, NB) for p in positions]
    P = sum(live) + 3
    k, v, ks, vs = _paged_pool(g, kind, L, P, Hkv, ps, D)
    pt = _scattered_table(g, B, NB, P, live)
    q = torch.randn((B, 1, Hkv * G, D), generator=g).to(BF16)
    pos = torch.tensor(positions, dtype=torch.int32)
    kw = dict(logit_softcap=softcap, window=window)
    want = t_pa.paged_attention(q, k, v, pt, 1, pos, k_scale=ks, v_scale=vs,
                                **kw)
    assert torch.isfinite(want).all()
    dev = [None if t is None else t.to(cuda) for t in (k, v, ks, vs)]
    before = (t_pa.launches, t_pa.int4_launches)
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    for _ in range(2):
        got = t_pa.paged_attention(q.to(cuda), dev[0], dev[1], pt.to(cuda), 1,
                                   pos.to(cuda), k_scale=dev[2],
                                   v_scale=dev[3], **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert (got.cpu().float() - want.float()).abs().max().item() <= tol
    int4 = kind == "int4"
    assert (t_pa.launches, t_pa.int4_launches) == (before[0] + 2 * (not int4),
                                                   before[1] + 2 * int4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("B,T,Hq,Hkv,starts,NB,window,softcap,D,nan", [
    (1, 256, 8, 8, (256,), 8, 0, 0.0, 128, False),      # history + fresh rows
    (2, 200, 8, 2, (0, 384), 8, 0, 0.0, 128, False),    # GQA, a ragged tail
    (1, 128, 4, 4, (300,), 4, 100, 30.0, 128, False),   # window, softcap
    # T off the 128-row tile, a history offset off it; NaN in the unused
    # pages and past the frontier in the last live page
    (1, 1000, 8, 8, (37,), 16, 0, 0.0, 128, True),
    (2, 160, 8, 2, (0, 70), 4, 0, 0.0, 256, True),      # D = 256 with GQA
    (1, 2048, 32, 32, (1024,), 24, 0, 0.0, 128, False),  # LLaMA-2-7B chunk
])
def test_k11_cuda_matches_plain(cuda, kind, B, T, Hq, Hkv, starts, NB,
                                window, softcap, D, nan):
    from llm_inference_tpu_torch.ops.kernels import paged_flash as t_pf
    g = torch.Generator().manual_seed(50 + T + NB)
    L, ps = 2, 128
    live = [min((s + T - 1) // ps + 1, NB) for s in starts]
    P = sum(live) + 2
    k, v, ks, vs = _paged_pool(g, kind, L, P, Hkv, ps, D)
    pt = _scattered_table(g, B, NB, P, live)
    if nan:
        used = {int(p) for b, n in enumerate(live) for p in pt[b, :n]}
        for p in set(range(P)) - used:
            if ks is None:
                k[:, p] = v[:, p] = float("nan")
            else:
                ks[:, p] = vs[:, p] = float("nan")
        for b, s in enumerate(starts):
            last = s + T - 1
            page, first = int(pt[b, last // ps]), last % ps + 1
            if ks is None:
                k[:, page, :, first:] = v[:, page, :, first:] = float("nan")
            else:
                ks[:, page, first:] = vs[:, page, first:] = float("nan")
    q = torch.randn((B, T, Hq, D), generator=g).to(BF16)
    pos = torch.stack([s + torch.arange(T) for s in starts]).to(torch.int32)
    kw = dict(logit_softcap=softcap, sliding_window=window)
    want = t_pf.paged_flash_attention(q, k, v, pt, 1, pos, k_scale=ks,
                                      v_scale=vs, **kw)
    assert torch.isfinite(want).all()
    dev = [None if t is None else t.to(cuda) for t in (k, v, ks, vs)]
    before = t_pf.launches
    got = t_pf.paged_flash_attention(q.to(cuda), dev[0], dev[1], pt.to(cuda),
                                     1, pos.to(cuda), k_scale=dev[2],
                                     v_scale=dev[3], **kw)
    torch.cuda.synchronize()
    assert t_pf.launches == before + 1
    assert torch.isfinite(got).all()
    # as K9: a few bf16 steps (2^-8 relative) of the largest output
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_paged_scheduler_cuda_matches_cpu(cuda, cache_dtype):
    """A small PagedScheduler run with prefix sharing and a second chunk,
    on the card (K1, K8, K10, K11) and on the CPU (plain versions): the
    greedy streams agree wherever the CPU run's top-2 logprob gap is
    wide."""
    from llm_inference_tpu_torch.config import (EngineConfig,
                                                GenerationConfig,
                                                QuantConfig, tiny_llama)
    from llm_inference_tpu_torch.engine.engine import InferenceEngine
    from llm_inference_tpu_torch.engine.scheduler import PagedScheduler
    from llm_inference_tpu_torch.models import llama
    from llm_inference_tpu_torch.ops.kernels import paged_attention as t_pa
    from llm_inference_tpu_torch.ops.kernels import paged_flash as t_pf
    cfg = tiny_llama(hidden_size=256, intermediate_size=512, num_heads=4,
                     num_kv_heads=2, head_dim=128, vocab_size=320,
                     dtype="bfloat16", max_position_embeddings=1024)
    params = llama.prepare_params(llama.init_params_quantized(
        cfg, QuantConfig(weights="int8", quantize_embedding=True), seed=3,
        device="cpu"))
    # random weights give near-flat logits (top-2 gaps below 0.01 at this
    # width); a sharper lm_head makes most of the stream comparable
    params["lm_head"].scale.mul_(64)
    g = torch.Generator().manual_seed(4)
    shared = torch.randint(1, 320, (256,), generator=g).tolist()
    prompts = [shared + torch.randint(1, 320, (n,), generator=g).tolist()
               for n in (60, 100, 140)]
    ecfg = EngineConfig(max_seq_len=1024, decode_chunk=4,
                        prefill_buckets=(128, 256), max_batch_size=2)
    runs = {}
    for dev in ("cpu", cuda):
        eng = InferenceEngine(cfg, llama.params_to(params, dev),
                              engine_cfg=ecfg, cache_dtype=cache_dtype,
                              device=dev)
        sched = PagedScheduler(eng, GenerationConfig(
            greedy=True, max_new_tokens=8, eos_token_ids=()),
            prefix_cache=True)
        before = (t_pa.launches + t_pa.int4_launches, t_pf.launches)
        reqs = [sched.submit(p, top_logprobs=2) for p in prompts]
        while sched.step():
            pass
        runs[str(dev)] = reqs
        if dev != "cpu":
            torch.cuda.synchronize()
            assert t_pa.launches + t_pa.int4_launches > before[0]
            assert t_pf.launches > before[1]
            assert sched.store.hit_tokens > 0
    compared = 0
    for c, d in zip(runs["cpu"], runs[str(cuda)]):
        assert len(d.output_ids) == 8
        for j, top in enumerate(c.output_top_logprobs):
            if top[0][1] - top[1][1] < 2e-2:
                break
            assert d.output_ids[j] == c.output_ids[j], (j, c.output_ids,
                                                        d.output_ids)
            compared += 1
    assert compared >= 12


# (hidden, intermediate, query heads) of _mega_layer's models: the card
# tests' small model, and LLaMA-2-7B's widths, where the int8 gate-up
# phase's 84 pairs a block on 132 SMs take two ring batches of at most 48
_MEGA_WIDTHS = {"small": (1024, 2816, 8), "7b": (4096, 11008, 32),
                "8b": (4096, 14336, 32)}


def _mega_layer(g, bits, kv, Hkv, S, pos, gsize=128, width="small"):
    """A 2-layer model's layer dict (random quantized weights, int4 in
    groups of gsize codes, random bf16 norms), a random cache of one
    sequence and the RoPE rows at pos."""
    from llm_inference_tpu_torch.config import QuantConfig, tiny_llama
    from llm_inference_tpu_torch.models import llama
    from llm_inference_tpu_torch.ops import kvcache
    H, I, Hq = _MEGA_WIDTHS[width]
    cfg = tiny_llama(hidden_size=H, intermediate_size=I, num_heads=Hq,
                     num_kv_heads=Hkv, head_dim=128, vocab_size=256,
                     dtype="bfloat16", max_position_embeddings=4096)
    qcfg = QuantConfig(weights=bits,
                       group_size=gsize if bits == "int4" else 0)
    params = llama.prepare_params(llama.init_params_quantized(
        cfg, qcfg, seed=5, device="cpu"))
    layers = params["layers"]
    for name in ("attn_norm", "ffn_norm"):
        layers[name] = (1 + 0.1 * torch.randn(layers[name].shape,
                                              generator=g)).to(BF16)
    cache = kvcache.init_cache(2, 1, Hkv, S, 128,
                               BF16 if kv == "bf16" else "int8",
                               device="cpu")
    if kv == "bf16":
        cache.k.copy_(torch.randn(cache.k.shape, generator=g))
        cache.v.copy_(torch.randn(cache.v.shape, generator=g))
    else:
        for c in (cache.k, cache.v):
            c.copy_(torch.randint(-128, 128, c.shape, generator=g))
        for s in (cache.k_scale, cache.v_scale):
            s.copy_(torch.rand(s.shape, generator=g) * 0.02 + 0.005)
    cos, sin = llama.rope_table(cfg, S, "cpu")
    return cfg, layers, cache, cos[pos][None, None], sin[pos][None, None]


def _mega_inputs(bits, kv, Hkv, S, pos, gsize=128, width="small"):
    """_mega_layer's model, cache and RoPE rows with random h and residual
    rows and the position, on the CPU (plain) and on the card (kernel):
    (cfg, CPU arguments of layer_kernel, card arguments)."""
    from llm_inference_tpu_torch.models import llama
    g = torch.Generator().manual_seed(pos + S)
    cfg, layers, cache, cos, sin = _mega_layer(g, bits, kv, Hkv, S, pos,
                                               gsize, width)
    H = cfg.hidden_size
    h = torch.randn((1, 1, H), generator=g).to(BF16)
    res = torch.randn((1, 1, H), generator=g).to(BF16)
    positions = torch.tensor([[pos]], dtype=torch.int32)
    dev = torch.device("cuda")
    dev_cache = dataclasses.replace(cache, **{
        f: getattr(cache, f).to(dev) for f in ("k", "v", "k_scale",
                                               "v_scale")
        if getattr(cache, f) is not None})
    host = (h, res, layers, cache, 1, positions, cos, sin)
    card = (h.to(dev), res.to(dev), llama.params_to(layers, dev), dev_cache,
            1, positions.to(dev), cos.to(dev), sin.to(dev))
    return cfg, host, card


@pytest.mark.cuda
@pytest.mark.parametrize("bits,kv,Hkv,S,pos", [
    ("int8", "bf16", 8, 512, 191), ("int8", "bf16", 2, 1024, 900),
    ("int4", "int8", 8, 512, 191), ("int4", "int8", 2, 1024, 0),
    ("int8", "int8", 8, 256, 255), ("int4", "bf16", 4, 512, 64),
    # G = 8 (one kv head), the kernel's kMaxG
    ("int4", "int8", 1, 512, 191), ("int8", "bf16", 1, 1024, 700),
    # the last slot of the cache: every slot but one is history
    ("int4", "bf16", 4, 512, 511)])
def test_k12_cuda_matches_plain(cuda, bits, kv, Hkv, S, pos, gsize=128):
    _k12_case(bits, kv, Hkv, S, pos, gsize, "small")


@pytest.mark.cuda
@pytest.mark.parametrize("bits,kv", [("int8", "bf16"), ("int4", "int8")])
def test_k12_7b_width_cuda_matches_plain(cuda, bits, kv):
    # LLaMA-2-7B widths: on 132 SMs the int8 gate-up phase's 84 pairs a
    # block take two ring batches
    _k12_case(bits, kv, 32, 512, 191, 128, "7b")


@pytest.mark.cuda
@pytest.mark.parametrize("bits,kv", [("int8", "bf16"), ("int4", "int8")])
def test_k12_llama3_8b_width_cuda_matches_plain(cuda, bits, kv):
    # Llama-3(.1)-8B's widths: 8 kv heads of 4 queries (G = 4), an
    # intermediate width of 14336
    _k12_case(bits, kv, 8, 1024, 700, 128, "8b")


def _k12_case(bits, kv, Hkv, S, pos, gsize, width):
    from llm_inference_tpu_torch.ops.kernels import layer_fused as t_lf
    cfg, host, card = _mega_inputs(bits, kv, Hkv, S, pos, gsize, width)
    assert t_lf.supports(cfg, host[0].shape, host[2], host[3])
    want = t_lf.layer_decode_fused_ref(cfg, *host)
    before = t_lf.launches
    got = t_lf.layer_kernel(cfg, *card)
    torch.cuda.synchronize()
    assert t_lf.launches == before + 1
    for name, a, b in zip(("h2", "down", "k_new", "v_new"), got, want):
        a, b = a.cpu().float(), b.float()
        assert torch.isfinite(a).all(), name
        # float32 sums in another order; the kernel rounds p to bf16 against
        # a running maximum, the plain version against the row maximum: a
        # few bf16 steps (2^-8 relative) of the largest value; k_new/v_new
        # round one float32 sum: one bf16 step (at most 2^-7 of it)
        tol = (2.0 ** -7 if name in ("k_new", "v_new") else 4 * 2.0 ** -8
               ) * b.abs().max().item()
        assert (a - b).abs().max().item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("bits,kv", [("int8", "bf16"), ("int8", "int8"),
                                     ("int4", "int8"), ("int4", "bf16")])
def test_k12_launches_repeat_bit_identical(cuda, bits, kv):
    # every sum is taken in a fixed order (no float atomics; the merge
    # takes the shares in share order): two launches on the same inputs
    # give the same bits
    from llm_inference_tpu_torch.ops.kernels import layer_fused as t_lf
    cfg, _, card = _mega_inputs(bits, kv, 8, 1024, 700)
    first = t_lf.layer_kernel(cfg, *card)
    second = t_lf.layer_kernel(cfg, *card)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
        assert torch.isfinite(a.float()).all()


@pytest.mark.cuda
def test_k12_failed_launch_raises(cuda):
    from llm_inference_tpu_torch.ops.kernels import _build
    # nine query heads a kv head is refused by the C entry point; the
    # wrapper's check raises
    code = _build.lib().layer_fused_launch(*([None] * 24), 4096, 9, 1, 512,
                                           11008, 0, 1, 1, 1, 1, 8, 1e-5,
                                           0.1, None)
    with pytest.raises(RuntimeError, match="K12"):
        _build.check(code, "layer_fused (K12)")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_row_writes_cuda_match_plain_exactly(cuda, kv):
    g = torch.Generator().manual_seed(12)
    L, Hkv, S, D = 2, 8, 64, 128
    kn = (torch.randn((Hkv, D), generator=g) * 3).to(BF16)
    vn = torch.randn((Hkv, D), generator=g).to(BF16)
    kn[2] = 0.0                                     # an all-zero row
    for off in (0, 9, S + 3):
        if kv == "bf16":
            cpu = [torch.randn((L, 1, Hkv, S, D), generator=g).to(BF16)
                   for _ in range(2)]
            fn = t_kvw.write_rows
        else:
            cpu = [torch.randint(-128, 128, (L, 1, Hkv, S, D), generator=g,
                                 dtype=torch.int8) for _ in range(2)]
            cpu += [torch.rand((L, 1, S, Hkv), generator=g) for _ in range(2)]
            fn = t_kvw.quantize_write_rows
        dev = [t.to(cuda) for t in cpu]
        before = (t_kvw.rows_launches, t_kvw.qrows_launches)
        fn(*cpu, 1, kn, vn, torch.tensor([off]))
        fn(*dev, 1, kn.to(cuda), vn.to(cuda),
           torch.tensor([off], device=cuda))
        torch.cuda.synchronize()
        assert (t_kvw.rows_launches + t_kvw.qrows_launches
                == sum(before) + 1)
        for a, b in zip(dev, cpu):
            assert torch.equal(a.cpu(), b)


# ------------------------------------ the RoPE and KV write (K3/K4)

def _rope_write_inputs(g, kind, B, T, H, Hkv, S, D, offs):
    """q, k, v as column slices of one bf16 qkv projection [B, T, (H +
    2 Hkv) D], the RoPE rows at the positions (clamped as forward clamps
    them), a random layer-2 cache of `kind` with its scales, on the CPU."""
    from llm_inference_tpu_torch.ops import rope
    qkv = (torch.randn((B, T, (H + 2 * Hkv) * D), generator=g) * 3).to(BF16)
    qkv[0, -1, H * D:(H + 1) * D] = 0.0               # an all-zero k row
    rows = [qkv[..., lo * D:(lo + n) * D].reshape(B, T, n, D)
            for lo, n in ((0, H), (H, Hkv), (H + Hkv, Hkv))]
    off = torch.tensor(offs, dtype=torch.int32)
    pos = torch.clamp(off[:, None] + torch.arange(T), max=S - 1).long()
    cos, sin = rope.make_rope_table(S, D)
    L, Dc = 3, D // 2 if kind == "int4" else D
    if kind == "bf16":
        cache = [torch.randn((L, B, Hkv, S, D), generator=g).to(BF16)
                 for _ in range(2)] + [None, None]
    else:
        cache = [torch.randint(-128, 128, (L, B, Hkv, S, Dc), generator=g,
                               dtype=torch.int8) for _ in range(2)]
        cache += [torch.rand((L, B, S, Hkv), generator=g) for _ in range(2)]
    return rows, cos[pos], sin[pos], off, cache


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("B,T,H,Hkv,D,offs", [
    (1, 1, 32, 32, 128, [191]),
    (4, 1, 32, 32, 128, [0, 77, 63, 90]),       # 63: the last slot, 90 past
    (2, 16, 8, 2, 64, [5, 70]),                 # a window past the end
    (1, 64, 8, 8, 128, [0]),
    (2, 3, 6, 2, 96, [10, 62]),                 # 3 values a lane
    (1, 1, 32, 32, 96, [63]),                   # phi3-mini's heads
    (1, 40, 32, 32, 96, [9]),
    (2, 7, 28, 4, 128, [3, 50]),                # qwen2-7b's heads
    (1, 5, 4, 1, 256, [30]),                    # 8 values a lane
    (2, 2, 4, 4, 32, [1, 2]),                   # 1 value a lane
])
def test_rope_write_cuda_matches_plain_exactly(cuda, kind, B, T, H, Hkv,
                                               D, offs):
    """The kernel against its plain version on the card and on the CPU:
    the rotated q, codes or rows and scales bit for bit (the plain
    version's divisions are IEEE ones on both)."""
    g = torch.Generator().manual_seed(B * 100 + T + D)
    S = 64
    bits = {"bf16": 16, "int8": 8, "int4": 4}[kind]
    (q, k, v), cos, sin, off, cache = _rope_write_inputs(
        g, kind, B, T, H, Hkv, S, D, offs)
    dev = [None if c is None else c.to(cuda) for c in cache]
    dev_plain = [None if c is None else c.clone() for c in dev]
    on = [t.to(cuda) for t in (q, k, v, cos, sin, off)]
    # the card's rows as the model hands them over: slices of one qkv
    qkv = torch.cat([t.reshape(B, T, -1) for t in (q, k, v)], -1).to(cuda)
    on[:3] = [qkv[..., lo * D:(lo + n) * D].reshape(B, T, n, D)
              for lo, n in ((0, H), (H, Hkv), (H + Hkv, Hkv))]
    before = t_kvw.rope_launches
    want = t_kvw.rope_write(q, k, v, cos, sin, off, cache[0], cache[1], 2,
                            cache[2], cache[3], bits)
    got = t_kvw.rope_write(*on, dev[0], dev[1], 2, dev[2], dev[3], bits)
    plain = t_kvw.rope_write_ref(*on, dev_plain[0], dev_plain[1], 2,
                                 dev_plain[2], dev_plain[3], bits)
    torch.cuda.synchronize()
    assert t_kvw.rope_launches == before + 1
    assert got.shape == (B, T, H, D) and got.is_contiguous()
    assert torch.equal(got.cpu(), want) and torch.equal(plain.cpu(), want)
    for a, p, c in zip(dev, dev_plain, cache):
        if c is not None:
            assert torch.equal(a.cpu(), c) and torch.equal(p.cpu(), c)


@pytest.mark.cuda
def test_rope_write_rejects_what_it_does_not_take(cuda):
    g = torch.Generator().manual_seed(3)
    (q, k, v), cos, sin, off, cache = _rope_write_inputs(
        g, "int8", 1, 1, 8, 2, 64, 128, [3])
    q, k, v, cos, sin, off = (t.to(cuda) for t in (q, k, v, cos, sin, off))
    kc, vc, ks, vs = (t.to(cuda) for t in cache)
    with pytest.raises(TypeError):
        t_kvw.rope_write(q.float(), k, v, cos, sin, off, kc, vc, 1, ks, vs,
                         8)
    with pytest.raises(ValueError):                 # D % 32
        t_kvw.rope_write(q[..., :80], k[..., :80], v[..., :80],
                         cos[..., :80], sin[..., :80], off,
                         kc[..., :80].contiguous(), vc[..., :80].contiguous(),
                         1, ks, vs, 8)
    with pytest.raises(ValueError):                 # D > 256
        w = torch.zeros((1, 1, 2, 288), dtype=BF16, device=cuda)
        t_kvw.rope_write(w, w, w, torch.zeros((1, 1, 288), device=cuda),
                         torch.zeros((1, 1, 288), device=cuda), off,
                         torch.zeros((3, 1, 2, 64, 288), dtype=torch.int8,
                                     device=cuda),
                         torch.zeros((3, 1, 2, 64, 288), dtype=torch.int8,
                                     device=cuda), 1, ks, vs, 8)
    with pytest.raises(ValueError):                 # a non-contiguous cache
        t_kvw.rope_write(q, k, v, cos, sin, off, kc.transpose(3, 4), vc, 1,
                         ks, vs, 8)
    with pytest.raises(ValueError):                 # int4 rows in an int8 one
        t_kvw.rope_write(q, k, v, cos, sin, off, kc, vc, 1, ks, vs, 4)
    with pytest.raises(ValueError):                 # more rows than slots
        t_kvw.rope_write(*(t.expand(1, 65, *t.shape[2:]) for t in (q, k, v)),
                         cos.expand(1, 65, 128), sin.expand(1, 65, 128), off,
                         kc, vc, 1, ks, vs, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_forward_writes_through_rope_write_on_the_card(cuda, kv):
    """A 2-layer bf16 model over a dense cache: every forward (a 16-row
    prefill of two sequences, then a decode step) launches the kernel once
    a layer and no K3, K4 or scale write."""
    from llm_inference_tpu_torch.config import QuantConfig, tiny_llama
    from llm_inference_tpu_torch.models import llama
    from llm_inference_tpu_torch.ops import kvcache
    cfg = tiny_llama(hidden_size=256, intermediate_size=512, num_heads=4,
                     num_kv_heads=2, head_dim=128, vocab_size=320,
                     dtype="bfloat16")
    params = llama.params_to(llama.prepare_params(llama.init_params_quantized(
        cfg, QuantConfig(weights="int8", quantize_embedding=True), seed=3,
        device="cpu")), cuda)
    cache = kvcache.init_cache(2, 2, 2, 64, 128,
                               BF16 if kv == "bf16" else kv, device=cuda)
    g = torch.Generator().manual_seed(6)
    ids = torch.randint(1, 320, (2, 16), generator=g, dtype=torch.int32)
    pos = torch.arange(16, dtype=torch.int32)[None].repeat(2, 1)
    before = (t_kvw.rope_launches, t_kvw.launches, t_kvw.quant_launches,
              t_kvw.scale_launches)
    with torch.no_grad():
        logits, cache = llama.forward(cfg, params, ids.to(cuda),
                                      pos.to(cuda), cache)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        logits, cache = llama.forward(cfg, params, tok,
                                      torch.full((2, 1), 16, device=cuda,
                                                 dtype=torch.int32), cache)
    torch.cuda.synchronize()
    assert (t_kvw.rope_launches - before[0], t_kvw.launches - before[1],
            t_kvw.quant_launches - before[2],
            t_kvw.scale_launches - before[3]) == (4, 0, 0, 0)
    assert torch.isfinite(logits).all()


# ------------------------------------ int4 groups of 8, 16 and 32 codes

@pytest.mark.cuda
@pytest.mark.parametrize("gsize", [8, 16, 32])
@pytest.mark.parametrize("M", [1, 4, 8, 32, 16, 128])
def test_k1_int4_small_groups_cuda_matches_plain(cuda, gsize, M):
    # M <= 8: the GEMV (the weight ring: a fold per m16n8k16 product for
    # groups of 16, per m16n8k8 half for 8, per 32-code chunk for 32);
    # M > 8: the MMA branch's mma.sync kernel (K8's qmm_tiled: a fold per
    # 32-code chunk, per m16n8k16 product, or per m16n8k8 half)
    g = torch.Generator().manual_seed(100 + gsize + M)
    K, N = 1024, 512
    qt = _int4_weight(g, 2, N, K, gsize)
    x = torch.randn((M, K), generator=g).to(BF16)
    kw = dict(norm_gamma=(1 + 0.1 * torch.randn((K,), generator=g)).to(BF16),
              residual=torch.randn((M, K), generator=g).to(BF16),
              want_x_out=True)
    want, want_x = t_qm.quant_matmul(x, qt, 1, **kw)
    before = t_qm.launches
    got, got_x = t_qm.quant_matmul(x.to(cuda), qt.to(cuda), 1,
                                   **_to(kw, cuda))
    torch.cuda.synchronize()
    assert t_qm.launches == before + 1
    assert torch.equal(got_x.cpu(), want_x)
    # as test_k1_int4_cuda_matches_plain: one bf16 step of the largest
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("gsize", [8, 16, 32])
def test_k8_small_groups_cuda_matches_plain(cuda, gsize):
    # the mma.sync kernel: groups of 32 fold after each 32-deep chunk, of
    # 16 after each m16n8k16 product, of 8 after each m16n8k8 half
    g = torch.Generator().manual_seed(200 + gsize)
    M, K, N = 200, 1024, 256
    qt = _int4_weight(g, 2, N, K, gsize)
    x = torch.randn((M, K), generator=g).to(BF16)
    want = t_qm.quant_matmul(x, qt, 1)
    before = t_qm.tiled_launches
    got = t_qm.quant_matmul(x.to(cuda), qt.to(cuda), 1)
    torch.cuda.synchronize()
    assert t_qm.tiled_launches == before + 1
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("gsize", [64, 128, 4096])
@pytest.mark.parametrize("M", [129, 1024])
def test_k8_wgmma_groups_cuda_matches_plain(cuda, gsize, M):
    # the wgmma kernel's int4 groups: one k step a group (64), two (128,
    # the main paths'), or one group a column (4096 = K)
    g = torch.Generator().manual_seed(400 + gsize + M)
    K, N = 4096, 512
    qt = _int4_weight(g, 2, N, K, gsize)
    x = torch.randn((M, K), generator=g).to(BF16)
    want = t_qm.quant_matmul(x, qt, 1)
    before = t_qm.tiled_launches
    got = t_qm.quant_matmul(x.to(cuda), qt.to(cuda), 1)
    torch.cuda.synchronize()
    assert t_qm.tiled_launches == before + 1
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.cuda
def test_k8_routes(cuda):
    # int8 and int4 groups of a multiple of 64 codes take the wgmma kernel
    # (1), groups of 8, 16 and 32 the mma.sync kernel (0), and the C entry
    # point refuses what neither takes (-1)
    from llm_inference_tpu_torch.ops.kernels import _build
    route = _build.lib().qmm_tiled_route
    K, N = 4096, 1024
    assert route(K, N, 1, 8) == 1
    for gsize in (64, 128, K):
        assert route(K, N, K // gsize, 4) == 1
    for gsize in (8, 16, 32):
        assert route(K, N, K // gsize, 4) == 0
    assert route(4608, N, 4608 // 48, 4) == -1      # groups of 48 codes
    assert route(K + 32, N, 1, 8) == -1
    assert route(K, N + 32, 1, 8) == -1
    # a last band of 64 weight rows (phi3's 32064, gemma3's 262208)
    assert route(K, N + 64, 1, 8) == 1
    assert route(K, N + 64, K // 128, 4) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits,K,N,gsize", [(4, 4608, 1024, 48),
                                            (8, 4128, 1024, 0),
                                            (8, 4096, 1056, 0)])
def test_k8_rejects_what_no_route_takes(cuda, bits, K, N, gsize):
    # groups of 48 codes, K not a multiple of 64, N not of 64: ValueError
    # before any launch
    g = torch.Generator().manual_seed(K + N)
    if bits == 4:
        qt = _int4_weight(g, 1, N, K, gsize)
    else:
        qt = QTensor(q=torch.zeros((1, N, K), dtype=torch.int8),
                     scale=torch.ones((1, 1, N)))
    x = torch.zeros((300, K), dtype=BF16, device=cuda)
    before = t_qm.tiled_launches
    with pytest.raises(ValueError, match="K8"):
        t_qm.quant_matmul(x, qt.to(cuda), 0)
    assert t_qm.tiled_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("gsize", [8, 16])
@pytest.mark.parametrize("M", [1, 4])
def test_k6_small_groups_cuda_matches_plain(cuda, gsize, M):
    g = torch.Generator().manual_seed(300 + gsize + M)
    H, I = 1024, 2816
    wo, gu, dn = (_int4_weight(g, 1, H, H, gsize),
                  _int4_weight(g, 1, 2 * I, H, gsize),
                  _int4_weight(g, 1, H, I, gsize))
    h = torch.randn((M, H), generator=g).to(BF16)
    attn = torch.randn((M, H), generator=g).to(BF16)
    gamma = (1 + 0.1 * torch.randn((H,), generator=g)).to(BF16)
    want = t_qm.layer_tail_fused(h, attn, wo, gu, dn, gamma, 1e-5, 0)
    got = t_qm.layer_tail_fused(h.to(cuda), attn.to(cuda), wo.to(cuda),
                                gu.to(cuda), dn.to(cuda), gamma.to(cuda),
                                1e-5, 0)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        err = (a.cpu().float() - b.float()).abs().max().item()
        assert err <= 2.0 ** -7 * b.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("gsize", [8, 16])
def test_k12_small_groups_cuda_matches_plain(cuda, gsize):
    test_k12_cuda_matches_plain(cuda, "int4", "int8", 8, 512, 191, gsize)


# ------------------------------------------------------------------- K7

@pytest.mark.cuda
@pytest.mark.parametrize("gsize,H,I", [(128, 4096, 5504), (32, 4096, 5504),
                                       (16, 1024, 2816), (8, 1024, 2816)])
@pytest.mark.parametrize("M", [1, 4, 8, 32])
def test_k7_cuda_matches_plain(cuda, gsize, H, I, M):
    # H = 4096, I = 5504: one rank's shard of LLaMA-2-7B at tp = 2
    g = torch.Generator().manual_seed(400 + gsize + M)
    gu = _int4_weight(g, 2, 2 * I, H, gsize)
    dn = _int4_weight(g, 2, H, I, gsize)
    x = torch.randn((M, H), generator=g).to(BF16)
    res = torch.randn((M, H), generator=g).to(BF16)
    gamma = (1 + 0.1 * torch.randn((H,), generator=g)).to(BF16)
    want_y, want_h2 = t_qm.ffn_fused(x, res, gamma, 1e-5, gu, dn, 1)
    before = t_qm.ffn_launches
    got_y, got_h2 = t_qm.ffn_fused(x.to(cuda), res.to(cuda), gamma.to(cuda),
                                   1e-5, gu.to(cuda), dn.to(cuda), 1)
    torch.cuda.synchronize()
    assert t_qm.ffn_launches == before + 1
    # h2 is the same float32 sum rounded once; y: float32 sums in another
    # order through two products, one rounding: one bf16 step of the
    # largest output
    assert torch.equal(got_h2.cpu(), want_h2)
    err = (got_y.cpu().float() - want_y.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want_y.float().abs().max().item()


@pytest.mark.cuda
def test_k7_failed_launch_raises(cuda):
    from llm_inference_tpu_torch.ops.kernels import _build
    # M = 0 is refused by the C entry point; the wrapper's check raises
    code = _build.lib().ffn_fused_launch(*([None] * 10), 0, 4096, 5504, 32,
                                         43, 1e-5, None)
    with pytest.raises(RuntimeError, match="ffn_fused"):
        _build.check(code, "ffn_fused")


# ----------------------------------------- K3/K4 at the latent widths

@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("kind", ["bf16", "int4"])
def test_k3_latent_widths_cuda_matches_plain(cuda, kind, B):
    """K3 with k rows of 576 values and v rows of 512 (DeepSeek-V3's latent
    cache, one kv head; bf16 rows, or the int4 cache's packed 288- and
    256-byte rows with the scale write), an offset past the end: bit for
    bit the plain version."""
    g = torch.Generator().manual_seed(60 + B)
    L, S = 3, 64
    kD, vD = (576, 512) if kind == "bf16" else (288, 256)
    off = torch.tensor([5, S + 3, 17, S - 1][:B], dtype=torch.int32)
    if kind == "bf16":
        caches = [torch.randn((L, B, 1, S, d), generator=g).to(BF16)
                  for d in (kD, vD)]
        new = [torch.randn((B, 1, 1, d), generator=g).to(BF16)
               for d in (kD, vD)]
    else:
        caches = [torch.randint(-128, 128, (L, B, 1, S, d), generator=g,
                                dtype=torch.int8) for d in (kD, vD)]
        new = [torch.randint(-128, 128, (B, 1, 1, d), generator=g,
                             dtype=torch.int8) for d in (kD, vD)]
    scales = [torch.rand((L, B, S, 1), generator=g) for _ in range(2)]
    snew = [torch.rand((B, 1, 1), generator=g) for _ in range(2)]
    dev = [t.to(cuda) for t in caches + scales]
    before = (t_kvw.launches, t_kvw.scale_launches)
    t_kvw.write_token(*caches, 2, *new, off)
    t_kvw.write_token(*dev[:2], 2, *(t.to(cuda) for t in new), off.to(cuda))
    if kind == "int4":
        t_kvw.write_token_scales(*scales, 2, *snew, off)
        t_kvw.write_token_scales(*dev[2:], 2, *(t.to(cuda) for t in snew),
                                 off.to(cuda))
    torch.cuda.synchronize()
    assert (t_kvw.launches, t_kvw.scale_launches) == (
        before[0] + 1, before[1] + (kind == "int4"))
    for d, h in zip(dev, caches + scales):
        assert torch.equal(d.cpu(), h)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype", [BF16, torch.float32])
@pytest.mark.parametrize("kD,vD,Hkv", [(576, 512, 1), (512, 512, 1),
                                       (320, 96, 2)])
def test_k4_latent_widths_cuda_matches_plain_exactly(cuda, in_dtype, kD, vD,
                                                     Hkv):
    """K4 at two widths, or one past 256 (the wide kernel): DeepSeek-V3's
    latent rows (k 576, v 512), the rows as the model hands them over
    (column slices of [c_kv | k_rot] and c_kv, strided), B = 4 with an
    offset past the end; codes and scales bit for bit the plain version,
    on the CPU and on the card (IEEE divisions there too)."""
    g = torch.Generator().manual_seed(kD + vD + Hkv)
    L, B, S = 2, 4, 64
    caches = [torch.randint(-128, 128, (L, B, Hkv, S, d), generator=g,
                            dtype=torch.int8) for d in (kD, vD)]
    caches += [torch.rand((L, B, S, Hkv), generator=g) for _ in range(2)]
    rows = (torch.randn((B, 1, Hkv, kD + vD + 32), generator=g) * 3).to(
        in_dtype)
    rows[1, 0, 0, :kD] = 0.0                        # an all-zero k row
    kn = rows[..., :kD].transpose(1, 2)
    vn = rows[..., kD + 32:].transpose(1, 2)
    off = torch.tensor([0, 9, S - 1, S + 3], dtype=torch.int32)
    dev = [t.to(cuda) for t in caches]
    dev_plain = [t.clone() for t in dev]
    before = t_kvw.quant_launches
    t_kvw.quantize_write_token(*caches, 1, kn, vn, off)
    t_kvw.quantize_write_token(*dev, 1, kn.to(cuda), vn.to(cuda),
                               off.to(cuda))
    t_kvw.quantize_write_token_ref(*dev_plain, 1, kn.to(cuda), vn.to(cuda),
                                   off.to(cuda))
    torch.cuda.synchronize()
    assert t_kvw.quant_launches == before + 1
    for a, p, b in zip(dev, dev_plain, caches):
        assert torch.equal(a.cpu(), b) and torch.equal(p.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,K,N,stack,idx", [
    # DeepSeek-V3: wkv_a (N = 576), an expert of the last MoE layer's
    # block of a 2-layer stack (index 1·256 + 255), its down projection
    (8, 7168, 576, 2, 1),
    (8, 7168, 2048, 512, 511),
    (8, 2048, 7168, 512, 300),
    # Mixtral-8x7B: expert 7 of layer 31 (index 31·8 + 7), int4 g=128
    (4, 4096, 14336, 256, 255),
    (4, 14336, 4096, 256, 255)])
@pytest.mark.parametrize("M", [1, 8, 128])
def test_k1_expert_stack_index_cuda_matches_plain(cuda, bits, K, N, stack,
                                                  idx, M):
    """K1 at the stack indices of the expert stacks [L·E, N, K'] (the
    weight and scale pointers offset by idx); the stacks hold random
    codes only at idx (the rest zero) so a wrong offset fails."""
    g = torch.Generator().manual_seed(idx + M)
    kb = K // 2 if bits == 4 else K
    G = K // 128 if bits == 4 else 1
    q = torch.zeros((stack, N, kb), dtype=torch.int8, device=cuda)
    q[idx] = torch.randint(-128, 128, (N, kb), generator=g,
                           dtype=torch.int8).to(cuda)
    sshape = (stack, N, G) if bits == 4 else (stack, 1, N)
    scale = torch.zeros(sshape, device=cuda)
    scale[idx] = (torch.rand(sshape[1:], generator=g) * 1e-3).to(cuda)
    qt = QTensor(q=q, scale=scale, bits=bits)
    x = torch.randn((M, K), generator=g).to(BF16).to(cuda)
    want = t_qm.quant_matmul_ref(x, qt, idx)
    got = t_qm.quant_matmul(x, qt, idx)
    torch.cuda.synchronize()
    assert want.abs().max() > 0
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()
