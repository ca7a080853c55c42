"""K1: int8 weight-only matmul with the fused residual + RMSNorm prologue
(counterpart of `llm_inference_tpu/ops/pallas/quant_matmul.py:quant_matmul`
and its blocked GEMV kernel, int8 per-channel).

    y = rms_norm(x (+ residual), gamma, eps) @ dequant(W[layer])

with the kernel's rounding points: x enters as bf16, the prologue runs in
float32, x_out = x + residual is stored as bf16, the normed rows are
rounded to bf16 for the dot, codes multiply in float32, the per-column
scale hits the float32 sum, and y is bf16 (then the caller's dtype).

CUDA tensors go through `csrc/quant_matmul.cu`; CPU tensors through
`quant_matmul_ref`, its plain version.
"""

from __future__ import annotations

import torch

from llm_inference_tpu_torch.ops.quantization import QTensor

_MAX_M = 128      # above this the TPU package runs its tiled kernel (K8)
# the CUDA kernel's GEMV takes up to 8 rows whose bf16 activations fit in
# 200 KiB of shared memory (csrc/quant_matmul.cu); larger M runs the MMA path
_GEMV_MAX_M = 8
_GEMV_MAX_SMEM = 200 * 1024

# kernel launches made by quant_matmul (the plain version is not counted)
launches = 0


def _rows(x):
    *lead, K = x.shape
    M = 1
    for d in lead:
        M *= d
    return lead, M, K


def _codes(qt: QTensor, layer):
    """float32 [K, N] codes and [N] scales of one layer."""
    if qt.stacked:
        qt = qt.layer(0 if layer is None else layer)
    return qt.q.to(torch.float32).T, qt.scale.reshape(-1)


def quant_matmul_ref(x, qt: QTensor, layer=None, *, norm_gamma=None,
                     norm_eps: float = 1e-5, residual=None,
                     want_x_out: bool = False):
    """Plain version of `quant_matmul` (same arguments and results)."""
    f32, bf16 = torch.float32, torch.bfloat16
    lead, M, K = _rows(x)
    fused = norm_gamma is not None or residual is not None
    x_full = None
    if M > _MAX_M:
        # the TPU package's prefill path: prologue outside the kernel, in
        # the caller's dtype, then the bf16 dot
        x32 = x.reshape(M, K).to(f32)
        if residual is not None:
            x32 = x32 + residual.reshape(M, K).to(f32)
        x_full = x32.to(x.dtype)
        if norm_gamma is not None:
            var = torch.mean(x32 * x32, dim=-1, keepdim=True)
            x32 = x32 * torch.rsqrt(var + norm_eps) * norm_gamma.to(f32)
        xn = x32.to(x.dtype).to(bf16) if fused else x.reshape(M, K).to(bf16)
    else:
        x2 = x.reshape(M, K).to(bf16)
        if fused:
            x32 = x2.to(f32)
            if residual is not None:
                x32 = x32 + residual.reshape(M, K).to(f32)
            x_full = x32.to(bf16)
            if norm_gamma is not None:
                var = torch.mean(x32 * x32, dim=-1, keepdim=True)
                x32 = x32 * torch.rsqrt(var + norm_eps)
                x32 = x32 * norm_gamma.to(f32)
            xn = x32.to(bf16)
        else:
            xn = x2
    w, s = _codes(qt, layer)
    y = ((xn.to(f32) @ w) * s).to(bf16)
    y = y.reshape(*lead, -1).to(x.dtype)
    if not want_x_out:
        return y
    if x_full is None:
        x_full = x.reshape(M, K)
    return y, x_full.reshape(*lead, K).to(x.dtype)


def quant_matmul(x, qt: QTensor, layer=None, *, norm_gamma=None,
                 norm_eps: float = 1e-5, residual=None,
                 want_x_out: bool = False):
    """y = [rms_norm(x (+ residual), norm_gamma)] @ dequant(qt[layer]).

    x: [..., K]; qt: one weight or a stack over layers with `layer` (a
    Python int) selecting the slice. Returns y [..., N] in x.dtype, and
    with want_x_out also x + residual (the new residual stream)."""
    if not x.is_cuda:
        return quant_matmul_ref(x, qt, layer, norm_gamma=norm_gamma,
                                norm_eps=norm_eps, residual=residual,
                                want_x_out=want_x_out)
    global launches
    from llm_inference_tpu_torch.ops.kernels import _build
    lead, M, K = _rows(x)
    N = qt.out_features
    if M > _MAX_M:
        raise NotImplementedError(
            f"M={M} > {_MAX_M}: the tiled prefill GEMM (K8) is not yet ported")
    if (qt.q.dtype != torch.int8 or not qt.q.is_contiguous()
            or qt.scale.dtype != torch.float32
            or not qt.scale.is_contiguous()):
        raise ValueError("K1 takes contiguous int8 codes [.., N, K] and "
                         "float32 scales (models.llama.prepare_params)")
    if K % 64 or N % 64:
        raise ValueError(f"K1 needs K % 64 == 0 and N % 64 == 0, got "
                         f"K={K} N={N}")
    bf16 = torch.bfloat16
    for name, t in (("residual", residual), ("norm_gamma", norm_gamma)):
        if t is not None and t.dtype != bf16:
            raise TypeError(f"K1 takes a bf16 {name}, got {t.dtype}")
    x2 = x.reshape(M, K).to(bf16).contiguous()
    res = None if residual is None else residual.reshape(M, K).contiguous()
    gam = None if norm_gamma is None else norm_gamma.reshape(K).contiguous()
    out = torch.empty((M, N), dtype=bf16, device=x.device)
    fused = norm_gamma is not None or residual is not None
    x_out = (torch.empty((M, K), dtype=bf16, device=x.device)
             if want_x_out and fused else None)
    # the MMA path normalises the rows once into this scratch; the GEMV
    # normalises in shared memory and takes none
    mma = M > _GEMV_MAX_M or M * K * 2 > _GEMV_MAX_SMEM
    xn = (torch.empty((M, K), dtype=bf16, device=x.device)
          if fused and mma else None)
    li = 0 if layer is None else int(layer)
    if not qt.stacked and li:
        raise ValueError("layer given for an unstacked weight")
    code = _build.lib().qmm_launch(
        x2.data_ptr(), None if res is None else res.data_ptr(),
        None if gam is None else gam.data_ptr(),
        qt.q.data_ptr() + li * N * K, qt.scale.data_ptr() + li * N * 4,
        out.data_ptr(), None if x_out is None else x_out.data_ptr(),
        None if xn is None else xn.data_ptr(), M, K, N, float(norm_eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "quant_matmul")
    launches += 1
    y = out.reshape(*lead, N).to(x.dtype)
    if not want_x_out:
        return y
    if x_out is None:
        return y, x
    return y, x_out.reshape(*lead, K).to(x.dtype)
